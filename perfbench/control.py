"""The check's control: the float32 reference put in the program's place
and computed one precision below the one the configuration states.  The
program serves and trains in bfloat16, so the control computes in fp8:
both operands of every matrix product and convolution (forward and, in
training, backward) rounded to float8 e4m3 with a per-tensor scale
(amax / 448), the products summed in float32, as an fp8 GEMM does.

  python3 perfbench/control.py --workload <name> --seeds 1,2,3

prints, for each seed, the numbers `perfbench.check` compares and
whether the control passed the cell's limits (it must not).  Eval: the
control answers the scenes a run's check compares first (the calls up to
the last one drawn for the stage checks); train: its first
`check_steps` steps against the float32 reference's.  Not run by the
benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check, inputs, loops, program, spec  # noqa: E402

aten = torch.ops.aten
# op -> positions of its operands that are rounded
PRODUCTS = {
    aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
    aten.convolution.default: (0, 1),
    aten.convolution_backward.default: (0, 1, 2),
}
FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x in float8 e4m3 with a per-tensor scale, back in x's dtype."""
    if not x.is_floating_point() or x.numel() == 0:
        return x
    amax = float(x.detach().abs().max())
    if amax == 0.0 or amax != amax:
        return x
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class Fp8Operands(TorchDispatchMode):
    """Every product's operands rounded by `round_fp8`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        pos = PRODUCTS.get(func)
        if pos is not None:
            args = list(args)
            for i in pos:
                if isinstance(args[i], torch.Tensor):
                    args[i] = round_fp8(args[i])
        return func(*args, **(kwargs or {}))


def eval_control(model_cfg: dict, traffic: dict, seed: int, device):
    """The control's answers and captures, as `EvalLoop.finish` gives
    them, for the calls a run's check compares first."""
    model = check.reference_model(model_cfg, traffic, seed, device, False)
    p = program.EvalProgram(model_cfg, traffic, seed, device, model=model,
                            cam=check.reference_cams(
                                inputs.rig(model_cfg, traffic), device))
    sample = loops._sampled(seed, traffic['check_calls'],
                            traffic['check_among_first'])
    caps = {}
    with torch.no_grad(), check.float32_exact(), Fp8Operands():
        for n in range(max(sample) + 1):
            cap = caps[n] = {} if n in sample else None
            p.call(n, capture=cap)
    p.free()
    return dict(loop='eval', outputs=p.outputs, captures={
        n: dict(c, scene=n % traffic['pool']) for n, c in caps.items()
        if c is not None})


def alter_answers(out: dict) -> dict:
    """The fault 'an answer altered where it is produced', planted in the
    control's answers: eval, each 2D detection moved 1 pixel right, each
    3D box 0.5 m along x; train, each query's assigned GT the next one."""
    for d in out.get('decisions', []):
        a, pos = d['match']
        G = d['match_in'][0].shape[-1]
        d['match'] = (torch.where(pos, (a + 1) % G, a), pos)
    for o in out.get('outputs', []):
        o['answer'][:, 0] += 0.5 * o['answer'][:, 11]
    for c in out.get('captures', {}).values():
        c['proposals']['boxes'] = c['proposals']['boxes'] + torch.tensor(
            [1.0, 0.0, 1.0, 0.0])
    return out


def control_numbers(workload: str, seed: int, bench_path=None,
                    device='cuda', limits=None, fault: bool = False
                    ) -> dict:
    """The control's numbers on one seed and its verdict (against the
    cell's limits, or `limits`)."""
    bench = spec.load_benchmark(bench_path)
    cell = spec.workload(bench, workload)
    model_cfg = spec.config(bench, cell['config'])
    traffic = spec.traffic(cell['traffic'])
    if traffic['loop'] == 'eval':
        out = eval_control(model_cfg, traffic, seed, device)
        if fault:
            out = alter_answers(out)
    else:
        steps = traffic['check_steps']
        out = check.train_reference(model_cfg, traffic, seed, device, steps,
                                    operands=Fp8Operands())
        out['loop'] = 'train'
        if fault:
            out = alter_answers(out)
    torch.cuda.empty_cache() if device == 'cuda' else None
    return check.judge(workload, cell, model_cfg, traffic, seed, out,
                       device, limits)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--fault', choices=('answer',), default=None,
                    help="plant the fault 'an answer altered where it is "
                         "produced' in the control's eval answers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('control: needs a CUDA device')
    for seed in (int(s) for s in args.seeds.split(',')):
        v = control_numbers(args.workload, seed, fault=bool(args.fault))
        for line in v['lines']:
            print(line, file=sys.stderr)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              fault=args.fault,
                              correct=v['correct'], numbers=v['numbers'])),
              flush=True)


if __name__ == '__main__':
    main()
