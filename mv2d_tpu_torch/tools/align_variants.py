"""B11 and B12's design variants, timed side by side on one GPU.

    python -m mv2d_tpu_torch.tools.align_variants    # from the repo root

The streamed RoIAlign core (`csrc/roi_align_stream.cuh`) fixes its TMA
box, its slot and its ring at compile time.  This script copies the
kernel sources into `csrc/build/variants/v<k>/`, rewrites those constants
in each copy, and applies the named edits of `EDITS`: `direct` keeps the
persistent walk but has the producer hand out each RoI's view instead of
issuing TMA boxes, and the consumer warps read their cells straight from
device memory with 16-byte non-coherent loads, as K3 does; each `off_*`
switches one phase off (its output is wrong by design, so it is timed
only).  It builds every variant with nvcc (all at once), holds the others
against the plain version (3e-2 of the max, bf16), and times each at the
main path's shapes in bf16 (B11 at [12, 1000] and [6, 512] anchor-like
RoIs, B12 on 12000 flat RoIs with adaptive sampling and S = 2: the inputs
`chip_smoke.py` times, from `synthetic`) beside K3 on the same RoIs, in
turns: K3, the variants, the variants in reverse, K3 (CUDA events, 5 runs
each).  Each variant is launched through the wrappers' own launch code
(`ops.roi_align.launch_slab` / `launch_flat` with the variant's library).
Prints each variant's registers, shared memory and blocks an SM, one line
a variant and case, then the card's name and power limit.  Needs a CUDA
device and nvcc.

The edits are written against the core's text: after a change to the core
an edit that no longer matches raises, naming its pattern, and is written
again for the new text.  Nothing imports this module.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import torch

from .. import kernels, synthetic
from ..ops import roi_align

# (name, box columns BX, slot columns SX, slot rows YS, ring slots, edits
# of the core); a variant whose edits switch a phase off computes the wrong
# answer by design and is timed only
VARIANTS = [
    ('tma b8 x32 y2 s3', 8, 32, 2, 3, ()),
    ('tma b16 x32 y2 s3', 16, 32, 2, 3, ()),
    ('tma b32 x32 y2 s3', 32, 32, 2, 3, ()),
    ('tma b8 x32 y1 s6', 8, 32, 1, 6, ()),
    ('tma b8 x24 y2 s4', 8, 24, 2, 4, ()),
    ('direct', 8, 32, 2, 3, 'direct'),
    ('off: row work', 8, 32, 2, 3, 'off_rows'),
    ('off: loads', 8, 32, 2, 3, 'off_loads'),
    ('off: weights', 8, 32, 2, 3, 'off_weights'),
    ('off: y sums', 8, 32, 2, 3, 'off_ysums'),
]
CORE = 'roi_align_stream.cuh'
# bf16 variants against the plain version: 3e-2 of its max magnitude
BF16_TOL = 3e-2
ENTRIES = ('roi_align_patch.cu', 'roi_align_slab.cu')

# the `direct` variant's edits of the core: (pattern, replacement, count)
DIRECT = [
    (r'(  float wy\[YS\]\[8\];[^\n]*\n)',
     r"\1  const void* src;                   // the RoI's view\n", 1),
    (r'const int nb = .*?full \+ s\);\n',
     'h->src = static_cast<const T*>(L.f[lvl]) +\n'
     '                     (size_t)v * L.H[lvl] * L.W[lvl] * C;\n'
     '            mbar_arrive(full + s);\n', 1),
    (r'const unsigned char\* cell = ring \+ s \* SLOT \+ lane \* 16 \+'
     r'\s*\(ca - x0\) \* cellb;',
     'const T* cell = static_cast<const T*>(h->src) + rec.c0 + lane * VW +\n'
     '                       ((size_t)y0 * rec.ax.n + ca) * C;', 1),
    (r'cell \+= cellb\)', 'cell += C)', 1),
    (r'\*reinterpret_cast<const uint4\*>\(cell \+ rr \* SX \* cellb\)',
     'ldg_nc_v4(cell + (size_t)min(rr, yhi - y0) * rec.ax.n * C)', 1),
]
# phases switched off, one at a time: the consumers' row work (wait and
# release only), the producer's TMA loads (it arrives with no bytes), the
# sums over samples behind each weight (a constant where it is not 0), the
# contraction along y (each row added to bin row 0 only)
OFF = {
    'off_rows': [(r'if \(ca <= cb\) \{', 'if (false) {', 1)],
    'off_loads': [(r'mbar_expect_tx\(full \+ s, rows.*?full \+ s\);\n',
                   'mbar_arrive(full + s);\n', 1)],
    'off_weights': [
        (r'rec\.ax\.weight\(j, ca \+ lane\)', '0.25f', 1),
        (r'ay\.weights\(y0 \+ lane, wy\);',
         'for (int i = 0; i < O; ++i) wy[i] = 0.25f;', 1)],
    'off_ysums': [
        (r'for \(int i = 0; i < O; \+\+i\) \{   // along y',
         'for (int i = 0; i < 1; ++i) {   // along y', 1)],
}
EDITS = {'direct': DIRECT, **OFF}


def _sub(text, pattern, repl, count):
    out, n = re.subn(pattern, repl, text, flags=re.S)
    if n != count:
        raise RuntimeError(f'variant edit {pattern!r} matched {n} times, '
                           f'expected {count}: the core changed')
    return out


def variant_source(bx, sx, ys, stages, edits=()):
    """The core's text with boxes of `bx` columns, slots of `ys` rows x `sx`
    columns, `stages` slots and the named edits (`EDITS`)."""
    text = (kernels.CSRC / CORE).read_text()
    text = _sub(text, r'constexpr int BX = \d+;', f'constexpr int BX = {bx};',
                1)
    text = _sub(text, r'SX = \d+, YS = \d+;', f'SX = {sx}, YS = {ys};', 1)
    text = _sub(text, r'constexpr int STAGES = \d+;',
                f'constexpr int STAGES = {stages};', 1)
    for pattern, repl, count in EDITS.get(edits, ()):
        text = _sub(text, pattern, repl, count)
    return text


def build_variants():
    """Build each variant into its own library -> {name: CDLL}."""
    root = kernels.BUILD_DIR / 'variants'
    shutil.rmtree(root, ignore_errors=True)
    nvcc = kernels._nvcc()
    procs, libs = [], {}
    for k, (name, bx, sx, ys, st, edits) in enumerate(VARIANTS):
        d = root / f'v{k}'
        d.mkdir(parents=True)
        for p in kernels.CSRC.glob('*.cuh'):
            shutil.copy(p, d / p.name)
        (d / CORE).write_text(variant_source(bx, sx, ys, st, edits))
        for e in ENTRIES:
            shutil.copy(kernels.CSRC / e, d / e)
            procs.append((name, d, subprocess.Popen(
                [nvcc, '-O3', '-std=c++17', '-Xcompiler', '-fPIC',
                 *kernels.ARCH_FLAGS, f'-I{d}', '-c', str(d / e), '-o',
                 str(d / (e + '.o'))], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, d, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{out}')
    for k, (name, *_) in enumerate(VARIANTS):
        d = root / f'v{k}'
        so = d / 'libvariant.so'
        subprocess.run([nvcc, *kernels.ARCH_FLAGS, '-shared', '-o', str(so),
                        *(str(d / (e + '.o')) for e in ENTRIES)],
                       check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ('mv2d_roi_align_flat', 'mv2d_roi_align_slab'):
            getattr(lib, fn).argtypes = kernels.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        plan = lib.mv2d_roi_align_stream_plan
        plan.argtypes = kernels.SIZES['mv2d_roi_align_stream_plan']
        plan.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def time_ms(fn, n=5):
    """Mean ms of n calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rel_err(got, want):
    """max |got - want| / max |want|, inf where got is not finite."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float('inf')
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-6)
            ).item()


def cases(dev):
    """(label, K3 call, plain call, variant call(lib)) at the main path's
    shapes in bf16."""
    strides = (4, 8, 16, 32)
    dt = torch.bfloat16
    out = []
    for V, P in ((12, 1000), (6, 512)):
        feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P)
        out.append((f'B11 [{V},{P}]',
                    lambda f=feats, r=rois: roi_align.roi_align_multilevel(
                        f, r, strides),
                    lambda f=feats, r=rois: roi_align.
                    multilevel_roi_align_plain(f, r, strides),
                    lambda lib, f=feats, r=rois: roi_align.launch_slab(
                        f, r, strides, handle=lib)[0]))
    feats, rois, views = synthetic.flat_roi_inputs(dev, dt)
    vp = rois.reshape(feats[0].shape[0], -1, 4)
    for S in (0, 2):
        out.append((f'B12 12000 S={S}',
                    lambda: roi_align.roi_align_multilevel(feats, vp,
                                                           strides),
                    lambda S=S: roi_align.multilevel_roi_align_flat_plain(
                        feats, rois, views, strides, S),
                    lambda lib, S=S: roi_align.launch_flat(
                        feats, rois, views, strides, S, handle=lib)))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit('align_variants: needs a CUDA device')
    libs = build_variants()
    for name, lib in libs.items():
        p = [lib.mv2d_roi_align_stream_plan(1, k) for k in range(7)]
        print(f'{name}: boxes of {p[0]} columns into {p[3]} slots of '
              f'{p[2]} x {p[1]} cells, {p[4]} bytes of dynamic shared '
              f'memory, {p[5]} registers, {p[6]} blocks an SM (bf16)',
              flush=True)
    for label, k3, plain, run in cases('cuda'):
        want = plain()
        for name, lib in libs.items():
            if name.startswith('off:'):
                continue
            rel = rel_err(run(lib), want)
            if not rel <= BF16_TOL:
                raise SystemExit(f'{name} {label}: rel {rel:.2e} FAIL')
        del want
        names = list(libs)
        ms = {n: [] for n in names}
        k3_ms = [time_ms(k3)]
        for n in names + names[::-1]:
            ms[n].append(time_ms(lambda: run(libs[n])))
        k3_ms.append(time_ms(k3))
        k3m = sum(k3_ms) / 2
        for n in names:
            m = sum(ms[n]) / 2
            print(f'  {label:<16} {n:<16} {m:.3f} ms ({ms[n][0]:.3f}, '
                  f'{ms[n][1]:.3f})  K3 {k3m:.3f} ms  ratio {m / k3m:.2f}',
                  flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
