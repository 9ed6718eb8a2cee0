"""Training checkpoints: the port's counterpart of
`mv2d_tpu/train/checkpoint.py` (`save_checkpoint`, `restore_checkpoint`,
`restore_variables`), as native torch files in mmcv's layout:

  {'meta': {'epoch', 'iter', 'seed', 'world_size', 'config'},
   'state_dict': model.state_dict(), 'optimizer': optimizer.state_dict()}

The state dict has the reference's key names, so `tools.test`,
`tools.serve` and anything that loads a reference `.pth` (`sd.get(
'state_dict', sd)`, strict=True) load a training checkpoint as it is.
`meta` holds plain Python values only and every tensor is on the CPU, so
`torch.load(path, weights_only=True)` reads the file anywhere.  A save
writes `<path>.tmp` and renames it, so a run cut during a save leaves no
torn `epoch_N.pth` behind.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import torch

_EPOCH_FILE = re.compile(r'epoch_(\d+)\.pth')


def _cpu(obj):
    """`obj` with every tensor copied to the CPU (dicts and lists kept)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[dict] = None):
    """Writes model (and optimizer) state and `meta` to `path`, atomically:
    a save that raises leaves neither `path` nor `<path>.tmp`."""
    ckpt = {'meta': dict(meta or {}), 'state_dict': _cpu(model.state_dict())}
    if optimizer is not None:
        ckpt['optimizer'] = _cpu(optimizer.state_dict())
    tmp = path + '.tmp'
    try:
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    """The file's dict ({'meta', 'state_dict'[, 'optimizer']}); a bare
    state dict comes back under 'state_dict' with an empty meta."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' not in ckpt:
        ckpt = {'meta': {}, 'state_dict': ckpt}
    return ckpt


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> dict:
    """Loads the model's state (strict=True) and, where given, the
    optimizer's -> the checkpoint's meta.  Layer1's folded blocks refold
    at the next forward (`load_state_dict` bumps every tensor's
    version)."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(ckpt['state_dict'], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    return ckpt['meta']


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The `epoch_N.pth` of `work_dir` with the highest N (`.tmp` files of a
    cut save are not checkpoints), or None."""
    if not os.path.isdir(work_dir):
        return None
    found = [(int(m.group(1)), name) for name in os.listdir(work_dir)
             if (m := _EPOCH_FILE.fullmatch(name))]
    return os.path.join(work_dir, max(found)[1]) if found else None


def load_from(model: torch.nn.Module, path: str
              ) -> Tuple[Dict[str, int], list, list]:
    """Initialises `model` from a `.pth` (a training checkpoint or a bare
    state dict with the reference's key names): every key that the model
    has is loaded, and a shape that differs raises.  Prints and returns
    (counts, missing keys, unexpected keys)."""
    if not path.endswith('.pth'):
        raise ValueError(f'{path}: load_from reads torch .pth files only')
    sd = load_checkpoint(path)['state_dict']
    own = model.state_dict()
    for k, v in sd.items():
        if k in own and own[k].shape != v.shape:
            raise ValueError(f'shape mismatch at {k}: {tuple(own[k].shape)} '
                             f'vs {tuple(v.shape)}')
    res = model.load_state_dict({k: v for k, v in sd.items() if k in own},
                                strict=False)
    unexpected = [k for k in sd if k not in own]
    counts = dict(loaded=len(sd) - len(unexpected),
                  missing=len(res.missing_keys), unexpected=len(unexpected))
    print(f'loaded {path}: {counts["loaded"]} tensors, '
          f'missing={counts["missing"]} unexpected={counts["unexpected"]}')
    return counts, list(res.missing_keys), unexpected
