"""Model export of the port: the counterpart of the repository's
`tools/export.py` (the reference's tools/deployment packaging).

  python -m mv2d_tpu_torch.tools.export <config> [--checkpoint X.pth]
      --out DIR [--cfg-options k=v ...] [--device cuda|cpu]

Exports the eval forward with `torch.export` at the config's fixed shapes
in the model's eval dtype (bfloat16 on the GPU, the default; float32 with
`--device cpu`).  The exported signature is the JAX tool's `serve`:

  (images [V, H, W, 3], intrinsics, extrinsics, img2lidar, ext_t_inv
   [V, 4, 4], trans_mats [V, V, 4, 4], timestamps [V], img_shapes [V, 2])
  -> (boxes [N, 9], scores [N], labels [N], valid [N])

with lidar2img = intrinsics @ extrinsics^T computed inside.  Every
hand-written kernel is one `torch.ops.mv2d.*` node (`ops.library`), the
NMS fixpoints are `while_loop` nodes, and layer1's folded blocks are
folded inside the program from its weights.  Writes DIR/mv2d_forward.pt2
(`torch.export.save`, weights included) and DIR/weights.pth (the model's
state dict, reference key names).  The weights come from the checkpoint
(strict=True), or are `synthetic.init_random_weights(seed=0)`.

Loading needs the operators and no model code:

  import torch, mv2d_tpu_torch.ops.library
  program = torch.export.load('DIR/mv2d_forward.pt2').module()
  boxes, scores, labels, valid = program(images, intrinsics, ...)
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch
import torch.nn as tnn

from ..core.geometry import CameraParams, prepare_camera_params
from ..synthetic import camera_rig
from .common import (build_model, device_and_dtype, load_cli_config,
                     load_weights)

PROGRAM = 'mv2d_forward.pt2'
WEIGHTS = 'weights.pth'


class ServeForward(tnn.Module):
    """The exported signature around an `MV2D` in eval mode."""

    def __init__(self, model: tnn.Module):
        super().__init__()
        self.model = model

    def forward(self, images, intrinsics, extrinsics, img2lidar, ext_t_inv,
                trans_mats, timestamps, img_shapes):
        cam = CameraParams(
            intrinsics=intrinsics, extrinsics=extrinsics,
            lidar2img=torch.einsum('vij,vkj->vik', intrinsics, extrinsics),
            img2lidar=img2lidar, ext_t_inv=ext_t_inv, trans_mats=trans_mats,
            timestamps=timestamps)
        det = self.model(images, cam, img_shapes)
        return det.boxes, det.scores, det.labels, det.valid


def rig_camera(mc, device) -> CameraParams:
    """`synthetic.camera_rig` for a model config, timestamps 0 / 0.5 for
    the two frames."""
    V = mc.total_views
    K, E = camera_rig(V, mc.image_size)
    return prepare_camera_params(
        K, E, [0.0] * mc.num_views + [0.5] * (V - mc.num_views),
        device=device)


def serve_args(images, cam: CameraParams, img_shapes):
    """The exported signature's arguments for a forward's inputs."""
    return (images, cam.intrinsics, cam.extrinsics, cam.img2lidar,
            cam.ext_t_inv, cam.trans_mats, cam.timestamps, img_shapes)


def example_inputs(mc, device, dtype, images: Optional[torch.Tensor] = None):
    """The exported signature's arguments for a model config: `images`
    (or zeros, as the JAX tool traces) on `rig_camera`."""
    V, (H, W) = mc.total_views, mc.image_size
    if images is None:
        images = torch.zeros((V, H, W, 3))
    return serve_args(images.to(device, dtype), rig_camera(mc, device),
                      torch.tensor([[H, W]] * V, device=device))


def export_model(model: tnn.Module, args) -> torch.export.ExportedProgram:
    """`torch.export` of `ServeForward(model)` on `args` (non-strict),
    traced with gradients off: the forward's own no-grad regions then
    change no mode, and the program holds no grad-mode region (whose node
    `torch.export.load` cannot validate)."""
    with torch.no_grad():
        return torch.export.export(ServeForward(model.eval()), tuple(args),
                                   strict=False)


def mv2d_nodes(program: torch.export.ExportedProgram):
    """The `mv2d` operator of each node of the program, its nested graphs
    (the loops') included, in graph order."""
    return [str(n.target) for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if str(n.target).startswith('mv2d.')]


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--out', required=True)
    p.add_argument('--cfg-options', nargs='*', default=None)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Runs the CLI; returns the program's path."""
    args = parse_args(argv)
    device, dtype = device_and_dtype(args.device)
    cfg = load_cli_config(args.config, args.cfg_options)
    model = load_weights(build_model(cfg), args.checkpoint)
    model = model.eval().to(device, dtype)
    program = export_model(model, example_inputs(model.cfg, device, dtype))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, PROGRAM)
    torch.export.save(program, path)
    torch.save(model.state_dict(), os.path.join(args.out, WEIGHTS))
    ops = mv2d_nodes(program)
    print(f'exported the eval forward ({str(dtype)[6:]}, '
          f'{model.cfg.total_views} views at {tuple(model.cfg.image_size)}, '
          f'{len(ops)} kernel nodes: '
          + ', '.join(sorted(set(ops))) + f') to {path}')
    print('load with: import torch, mv2d_tpu_torch.ops.library; '
          f"program = torch.export.load('{path}').module(); "
          'boxes, scores, labels, valid = program(images, intrinsics, '
          'extrinsics, img2lidar, ext_t_inv, trans_mats, timestamps, '
          'img_shapes)')
    return path


if __name__ == '__main__':
    main()
