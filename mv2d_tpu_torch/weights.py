"""JAX parameter trees -> the port's state_dict (reference key names).

`state_dict_from_jax(params, constants)` is the inverse of
`mv2d_tpu/train/checkpoint.py:convert_torch_state_dict`: it takes the JAX
package's nested {'params', 'constants'} trees (numpy arrays) of an MV2D
model (ResNet or VoVNet backbone, two-stage or single-stage detector)
and returns reference-named numpy arrays that load into
`mv2d_tpu_torch.models.mv2d.MV2D` with strict=True; a flax `Embed`
table at the top of the tree (`LearnedPositionalEncoding3D`'s) becomes
its `nn.Embedding` weight.  The single-stage head takes mmdet
RetinaHead's names (the JAX converter has no table for it).  Layout
changes:
conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in], the DCN
tap kernel [9, C, F] -> [F, C, 3, 3], the R-CNN fc1 input order
(7, 7, C) -> (C, 7, 7), and per-attention q/k/v projections packed into
in_proj_{weight,bias}.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}
_LN = {'scale': 'weight', 'bias': 'bias'}
_CLS_IDX = {'fc0': 0, 'ln0': 1, 'fc1': 3, 'ln1': 4, 'out': 6}
_REG_IDX = {'fc0': 0, 'fc1': 2, 'out': 4}


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        elif not str(k).startswith('_'):
            out[path] = np.asarray(v)
    return out


def _conv(w):
    if w.ndim == 3:                      # DCN taps [9, C, F] -> [F, C, 3, 3]
        k = int(round(w.shape[0] ** 0.5))
        w = w.reshape(k, k, *w.shape[1:])
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):
    return np.transpose(w, (1, 0))


def _raw(w):
    return w


def _leaf(leaf: str):
    """kernel/bias -> (torch leaf, transform for a conv or dense)."""
    return ('weight', True) if leaf == 'kernel' else ('bias', False)


def _resnet_key(p: str):
    m = re.fullmatch(r'stem_conv/kernel', p)
    if m:
        return 'conv1.weight', _conv
    m = re.fullmatch(r'stem_bn/(\w+)', p)
    if m:
        return f'bn1.{_BN[m.group(1)]}', _raw
    m = re.fullmatch(r'layer(\d)_(\d+)/(.*)', p)
    if not m:
        return None
    base = f'layer{m.group(1)}.{m.group(2)}'
    rest = m.group(3)
    mm = re.fullmatch(r'conv(\d)/kernel', rest)
    if mm:
        return f'{base}.conv{mm.group(1)}.weight', _conv
    mm = re.fullmatch(r'conv2/conv_offset/(kernel|bias)', rest)
    if mm:
        leaf, is_w = _leaf(mm.group(1))
        return f'{base}.conv2.conv_offset.{leaf}', _conv if is_w else _raw
    mm = re.fullmatch(r'bn(\d)/(\w+)', rest)
    if mm:
        return f'{base}.bn{mm.group(1)}.{_BN[mm.group(2)]}', _raw
    mm = re.fullmatch(r'downsample_conv/kernel', rest)
    if mm:
        return f'{base}.downsample.0.weight', _conv
    mm = re.fullmatch(r'downsample_bn/(\w+)', rest)
    if mm:
        return f'{base}.downsample.1.{_BN[mm.group(1)]}', _raw
    return None


def _vovnet_key(p: str):
    """The inverse of `mv2d_tpu/train/checkpoint.py:_map_vovnet`: JAX
    stem_{i} / stage{s}_{b} (0-indexed) -> VoVNetCP's stem.stem_{i+1} /
    stage{s}.OSA{s}_{b+1} names."""
    m = re.fullmatch(r'stem_(\d)/(conv|bn)/(\w+)', p)
    if m:
        base = f'stem.stem_{int(m.group(1)) + 1}'
        rest = m.group(2, 3)
    else:
        m = re.fullmatch(r'stage(\d)_(\d+)/(.*)', p)
        if not m:
            return None
        st, blk = m.group(1), int(m.group(2)) + 1
        osa = f'stage{st}.OSA{st}_{blk}'
        mm = re.fullmatch(r'ese/fc/(kernel|bias)', m.group(3))
        if mm:
            leaf, is_w = _leaf(mm.group(1))
            return f'{osa}.ese.fc.{leaf}', _conv if is_w else _raw
        mm = re.fullmatch(r'(layer_(\d+)|concat)/(conv|bn)/(\w+)',
                          m.group(3))
        if not mm:
            return None
        if mm.group(2) is not None:
            base = f'{osa}.layers.{mm.group(2)}.OSA{st}_{blk}_{mm.group(2)}'
        else:
            base = f'{osa}.concat.OSA{st}_{blk}_concat'
        rest = mm.group(3, 4)
    if rest == ('conv', 'kernel'):
        return f'{base}/conv.weight', _conv
    if rest[0] == 'bn' and rest[1] in _BN:
        return f'{base}/norm.{_BN[rest[1]]}', _raw
    return None


def _retina_key(p: str):
    """JAX RetinaHead leaves -> mmdet RetinaHead names."""
    m = re.fullmatch(r'(cls|reg)_conv(\d+)/(kernel|bias)', p)
    if m:
        leaf, is_w = _leaf(m.group(3))
        return (f'{m.group(1)}_convs.{m.group(2)}.conv.{leaf}',
                _conv if is_w else _raw)
    m = re.fullmatch(r'(retina_cls|retina_reg)/(kernel|bias)', p)
    if m:
        leaf, is_w = _leaf(m.group(2))
        return f'{m.group(1)}.{leaf}', _conv if is_w else _raw
    return None


def _fpn_key(p: str, start_level: int):
    m = re.fullmatch(r'(lateral|fpn)_(\d+)/(kernel|bias)', p)
    if not m:
        return None
    which = 'lateral_convs' if m.group(1) == 'lateral' else 'fpn_convs'
    leaf, is_w = _leaf(m.group(3))
    return (f'{which}.{int(m.group(2)) - start_level}.conv.{leaf}',
            _conv if is_w else _raw)


def _rcnn_fc1(w):
    """[49*C, out] rows in (7, 7, C) order -> [out, C*49] in (C, 7, 7)."""
    in_d, out_d = w.shape
    C = in_d // 49
    return w.T.reshape(out_d, 7, 7, C).transpose(0, 3, 1, 2) \
        .reshape(out_d, in_d)


def _table(p: str, rules):
    for pattern, target, kind in rules:
        m = re.fullmatch(pattern, p)
        if m:
            leaf, is_w = _leaf(m.group(m.lastindex))
            idx = m.group(1) if m.lastindex > 1 else None
            name = target(idx) if callable(target) else target
            return f'{name}.{leaf}', kind if is_w else _raw
    return None


_PE_RULES = [
    (r'position_encoder_(\d)/(kernel|bias)',
     lambda i: f'position_encoder.{2 * int(i)}', _conv),
    (r'adapt_pos3d_(\d)/(kernel|bias)',
     lambda i: f'adapt_pos3d.{2 * int(i)}', _conv),
    (r'fpe/(conv_reduce|conv_expand)/(kernel|bias)',
     lambda n: f'fpe.{n}', _conv),
]
_QG_RULES = [
    (r'shared_conv/(kernel|bias)', 'shared_convs.0.conv', _conv),
    (r'shared_fc/(kernel|bias)', 'shared_fcs.0', _lin),
    (r'extra_enc_(\d)/(kernel|bias)',
     lambda i: f'extra_enc.{2 * int(i)}', _lin),
    (r'fc_center/(kernel|bias)', 'fc_center', _lin),
]


def _head_key(p: str, packed: Dict[str, Dict[str, np.ndarray]],
              value: np.ndarray):
    """bbox_head/* (3D head); q/k/v projections are collected in packed."""
    m = re.fullmatch(r'query_embedding_(\d)/(kernel|bias)', p)
    if m:
        leaf, is_w = _leaf(m.group(2))
        return f'query_embedding.{2 * int(m.group(1))}.{leaf}', \
            _lin if is_w else _raw
    m = re.fullmatch(r'decoder/post_norm/(scale|bias)', p)
    if m:
        return f'transformer.decoder.post_norm.{_LN[m.group(1)]}', _raw
    m = re.fullmatch(r'decoder/layer_(\d+)/(.*)', p)
    if m:
        base = f'transformer.decoder.layers.{m.group(1)}'
        rest = m.group(2)
        mm = re.fullmatch(r'(self_attn|cross_attn)/(q|k|v)_proj/(kernel|bias)',
                          rest)
        if mm:
            i = 0 if mm.group(1) == 'self_attn' else 1
            leaf, is_w = _leaf(mm.group(3))
            key = f'{base}.attentions.{i}.attn.in_proj_{leaf}'
            packed.setdefault(f'roi_head.bbox_head.{key}', {})[
                mm.group(2)] = _lin(value) if is_w else value
            return key, None
        mm = re.fullmatch(r'(self_attn|cross_attn)/out_proj/(kernel|bias)',
                          rest)
        if mm:
            i = 0 if mm.group(1) == 'self_attn' else 1
            leaf, is_w = _leaf(mm.group(2))
            return f'{base}.attentions.{i}.attn.out_proj.{leaf}', \
                _lin if is_w else _raw
        mm = re.fullmatch(r'ffn/fc(\d)/(kernel|bias)', rest)
        if mm:
            leaf, is_w = _leaf(mm.group(2))
            sub = 'layers.0.0' if mm.group(1) == '1' else 'layers.1'
            return f'{base}.ffns.0.{sub}.{leaf}', _lin if is_w else _raw
        mm = re.fullmatch(r'norm(\d)/(scale|bias)', rest)
        if mm:
            return (f'{base}.norms.{int(mm.group(1)) - 1}.'
                    f'{_LN[mm.group(2)]}', _raw)
        return None
    m = re.fullmatch(r'cls_branch_(\d+)/(\w+)/(kernel|bias|scale)', p)
    if m:
        idx = _CLS_IDX[m.group(2)]
        if m.group(2).startswith('ln'):
            return f'cls_branches.{m.group(1)}.{idx}.{_LN[m.group(3)]}', _raw
        leaf, is_w = _leaf(m.group(3))
        return f'cls_branches.{m.group(1)}.{idx}.{leaf}', \
            _lin if is_w else _raw
    m = re.fullmatch(r'reg_branch_(\d+)/(\w+)/(kernel|bias)', p)
    if m:
        leaf, is_w = _leaf(m.group(3))
        return f'reg_branches.{m.group(1)}.{_REG_IDX[m.group(2)]}.{leaf}', \
            _lin if is_w else _raw
    return None


def torch_key(path: str, packed, value):
    """JAX leaf path -> (torch key, transform) or None if unknown."""
    top, _, p = path.partition('/')
    if top == 'base_detector':
        sub, _, q = p.partition('/')
        if sub == 'backbone':
            r = _resnet_key(q) or _vovnet_key(q)
            return r and (f'base_detector.backbone.{r[0]}', r[1])
        if sub == 'retina_head':
            r = _retina_key(q)
            return r and (f'base_detector.bbox_head.{r[0]}', r[1])
        if sub == 'fpn':
            r = _fpn_key(q, 0)
            return r and (f'base_detector.neck.{r[0]}', r[1])
        m = re.fullmatch(r'rpn_head/rpn_(conv|cls|reg)/(kernel|bias)', p)
        if m:
            leaf, is_w = _leaf(m.group(2))
            return (f'base_detector.rpn_head.rpn_{m.group(1)}.{leaf}',
                    _conv if is_w else _raw)
        m = re.fullmatch(r'bbox_head/(shared_fc\d|fc_cls|fc_reg)/'
                         r'(kernel|bias)', p)
        if m:
            leaf, is_w = _leaf(m.group(2))
            name = m.group(1)
            if name.startswith('shared_fc'):
                name = f'shared_fcs.{int(name[-1]) - 1}'
            kind = (_rcnn_fc1 if name == 'shared_fcs.0' else _lin) \
                if is_w else _raw
            return f'base_detector.roi_head.bbox_head.{name}.{leaf}', kind
        return None
    if top == 'neck':
        r = _fpn_key(p, 2)
        return r and (f'neck.{r[0]}', r[1])
    if top == 'pe':
        r = _table(p, _PE_RULES)
        return r and (f'roi_head.position_encoding.{r[0]}', r[1])
    if top == 'query_generator':
        r = _table(p, _QG_RULES)
        return r and (f'roi_head.query_generator.{r[0]}', r[1])
    if top == 'bbox_head':
        r = _head_key(p, packed, value)
        return r and (f'roi_head.bbox_head.{r[0]}', r[1])
    m = re.fullmatch(r'(\w+_embed)/embedding', path)
    if m:                         # flax Embed [n, F] = nn.Embedding [n, F]
        return f'{m.group(1)}.weight', _raw
    return None


def state_dict_from_jax(params: Mapping, constants: Mapping
                        ) -> Dict[str, np.ndarray]:
    """JAX MV2D {'params'} and {'constants'} trees -> reference-named
    state dict (numpy).  Raises on a leaf it cannot place."""
    flat = {**_flatten(params), **_flatten(constants)}
    out: Dict[str, np.ndarray] = {}
    packed: Dict[str, Dict[str, np.ndarray]] = {}
    for path, value in flat.items():
        r = torch_key(path, packed, value)
        if r is None:
            raise KeyError(f'no torch key for JAX leaf {path}')
        key, fn = r
        if fn is not None:
            out[key] = np.ascontiguousarray(fn(value))
        if key.endswith('.running_mean'):
            out[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                np.zeros((), np.int64)
    for key, parts in packed.items():
        out[key] = np.concatenate([parts['q'], parts['k'], parts['v']], 0)
    return out

