"""Smoke run of the PyTorch/CUDA port (mv2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure exits non-zero without the final line:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from mv2d_tpu_torch/csrc (nvcc, sm_90a, one
     nvcc per source, all started together);
  3. kernels: each kernel against its plain PyTorch version (a backward
     kernel against the plain version's autograd) at the shapes of the
     eval path (12 views at 512x1408), of the training step and, for B12,
     of the JAX package's micro-bench (12000 RoIs on random views), plus
     edge cases: float32 with TF32 off (max error <= 1e-4 of the reference's
     max magnitude) and bfloat16 (<= 3e-2).  The main-path cases are
     timed (kernel, plain version, and for attention the masked
     F.scaled_dot_product_attention, timed only) beside their bound: the
     larger of the bytes the function moves over 3.35 TB/s and its
     operations over 989 TFLOP/s (H100 SXM bf16 peaks), and the bound's
     share of the kernel's time.  K2's cases also time B5 plus one
     torch.matmul on the same inputs (`b5_matmul_ms`, a yardstick the port
     never runs) and name their shape's launches per eval forward.  K1's
     case also times block 0 and an identity block alone and gives the
     chain's share of its three-launch floor (each launch reads its input
     and writes its output once: 1.45 GB at [12,128,352,64]) beside its
     share of the bound; K1 is also checked at R101's layer1 shape.  K2
     is also timed at R101's four DCN shapes at 640x1600 (stage 3 from
     [12,80,200,256], 22 stride-1 layers at [12,40,100,256]; stage 4 from
     [12,40,100,512], two at [12,20,50,512]), and K4 and `mask_bits` at
     R101's cross attention over every p4 pixel (q900 k48000), each with
     its launches per R101 forward.  The
     attention kernels read the mask as
     the decoder hands it to them, packed once a pass (`mask_tiles`); the
     packing kernel has cases of its own, equal bit for bit, timed beside
     the whole per-pass build (the bits and both tile lists).  B5 and B6
     are timed at all four DCN stage shapes as the step calls them (every
     launch and allocation; B6's bound counts dx in the input's dtype, and
     its log line also gives the bound with a float32 dx, its first
     form's); B5 is also checked on ragged pixel tiles [1,13,21,40], B6 on
     a pile-up of every sample on one cell and a ragged [1,13,21,40].  B9
     is timed at the training RoIs [6,512] on R50's and R101's levels (its
     bound counts the level gradients in the features' dtype, and its log
     line also gives the bound with float32 ones, its first form's), and
     checked on a finest level 560 cells wide, on a pile-up of 512
     identical RoIs a view and for equal bits in two runs; the bound of
     the forward RoIAlign kernels (K3, B11, B12) counts the levels' cells
     that their RoIs' footprints cover, once per (view, level), and their
     log line also gives the bound with every level read whole; K3 is also
     timed at R101's levels and on 64 of the channels of its main case
     (`c64_ms`), and checked on slivers only.
     B13 is timed at its three stage shapes beside the route's forward +
     backward a layer (`route_fwd_bwd_ms`) and the default route's
     (`default_route_fwd_bwd_ms`), logs its transient workspace, and is
     checked on a pile-up of every sample on one cell and for equal bits in
     two runs; B10's cases time the cuDNN chain it replaces as `library`,
     log its bf16 tile and the shared memory a block takes, and are checked
     on ragged tiles at both widths and for equal bits in two runs; B11
     and B12 are timed beside K3 on the same RoIs (`k3_ms`), log their
     plan (box, ring slots, blocks an SM, registers, shared memory), and
     are checked on a finest level 560 cells wide and for equal bits in
     two runs.  The NMS kernel's keep masks equal the plain scan's bit
     for bit (on the same CUDA tensors) at the RPN's [12,5,1000], the
     R-CNN's [12,1000] and the training proposals' [6,5,2000], with float32
     boxes rounded through bfloat16 in the bf16 pass, and on duplicates, a
     row all invalid, suppression chains, bfloat16 boxes, ragged and
     one-box rows and 3000 boxes a row; its bound counts the pairs' 13
     float32 operations at 67 TFLOP/s.  Then each `mv2d` operator's host
     microseconds a call
     (`torch.ops.mv2d.*`) against a direct call of its CUDA
     implementation on the same arguments (`op_args`), and their cost
     per eval forward and per training step;
  4. tiny: the tiny config with DCN, eval forward, GPU (kernels) against
     CPU (plain versions), same seeded weights, the GPU launching exactly
     the path's kernels (`path_kernels`);
  5. tiny_train: one tiny+DCN training step (float32, TF32 off, dropout
     0), GPU against CPU with the same weights and draws: every loss and
     every parameter's gradient;
     variants_tiny: the same two checks on the other model families:
     the roi key mode (MV2D-S) forward and, with DN, a step; the
     single-stage (RetinaNet) detector's forward and step; the VoVNet-19
     backbone's forward (its boxes held against the CPU's boxes of the
     same label and score: near-tied queries may swap slots);
  6. serve: three full-width MV2D-T R50 forwards (12 x 512 x 1408, k_max
     16384) in bfloat16 with seeded weights (bench fixture rules): finite
     outputs of the expected shapes, exactly the path's kernels launched
     (K4 and `mask_bits` as many times as the decoder has shared-key
     masks), ms per forward and peak memory, and the inputs each kernel
     saw first replayed through its plain version; serve_s: the same on
     three MV2D-S R50 forwards (roi key mode, 6 x 512 x 1408, no DCN: K1,
     K3, K4 on the self-attention, `mask_bits` once a forward; the
     cross-attention is per query, in batched matmuls); serve_v99: two
     MV2D-T forwards on the VoVNet-99 backbone (K3, K4, no K1 or K2);
     serve_all: two MV2D-T R50 forwards under the reference's
     'all_matched' correlation (every RoI with a positive hull IoU
     correlates: a [900, 901] table; K1-K4 as in serve, key_active and
     key_overflow printed); serve_s_all: two MV2D-S R50 forwards under
     'all_matched' (each query's keys the cells of all 451 RoIs,
     [450, 22099, 256]) when its reckoned peak
     (`serve_peak_estimate_gb`) stays within 90% of the card's memory,
     else the reckoning printed and the forward skipped;
     export: `tools.export` of MV2D-T R50 bf16 at full width on the
     serve phase's weights and inputs (one `mv2d` node a kernel call:
     K1 3, K2 9, K3 1, K4 12, mask_bits 2), the .pt2 loaded and run 4
     times in a fresh `python -c` that imports only the operators
     (`mv2d_tpu_torch.ops.library`): its detections equal to a direct
     forward bit for bit, its launches 4 x the forward's, no model module
     imported; ms/scene of both, and the operators each dispatches;
  7. http: the port's HTTP server (`mv2d_tpu_torch.tools.serve`) in
     process on 127.0.0.1, built from the R50 file of configs/mv2d/ with
     align_v2 (the JAX package's MV2D_ALIGN_V2=1: kernel B11), max
     batch 2: one request, then three at once, each response equal to a
     direct forward of the same model on the same arrays, B11 launched
     once a forward and K3 never, the /metrics counts, a bad request
     answered 400; then `roi_forward` (kernel B12) on that scene's FPN
     levels and flattened proposals, its RoI features against K3's and
     B11's; then one request to a server built from the R101 1600x640
     file (k_max 24576); then one to a server built from the MV2D-S file
     (roi key mode), its answer equal to a direct forward;
  8. eval: the eval path from disk to metrics.  Renders 8 val scenes of
     the port's synthetic fixture (`tools.make_synth_fixture`: 1600x900
     JPEGs of six cameras, 14 objects a scene), saves the serve phase's
     seeded weights as a .pth and runs the port's `tools/test.py` `main`
     on the R50 file, data.val pointed at the fixture by --cfg-options
     (two frames from an empty sweep list: 12 views, the C++ pool to
     512x1408, bf16 forwards, nuScenes metrics, a submission json); then
     `tools.eval_e2e_bench.run` on the same fixture, 3 repeats of 16
     scenes.  Checks: the submission has one entry per scene with the
     devkit's keys; mAP, NDS and the ten class APs are finite; launches
     are the forwards times K1 3, K2 9, K3 1, K4 12 and mask_bits 2, every
     other kernel 0; the C++ pool ran once a scene; scene 0's records
     equal a direct forward on its `to_eval_inputs` within 3e-2 of max;
     its pool images within 0.05 mean abs of the numpy path.  Logs
     samples/s and the ms a scene of the bench's parts (sample, wait,
     h2d, forward, convert) with the card's name and power limit;
     parity: the acceptance harness (`tools.parity`, --synthetic) on
     the R50 file at full width: the RoI head's stand-in state dict
     loaded with every key taken; the golden of one 6-view frame (8
     proposals a view) through the bf16 port against the float32
     reference transcription on the host: pe, virtual_intrinsics,
     roi_align, decoder_cls and decoder_box each within 3e-2 of its
     stage's largest reference value, proposals found, key_overflow 0;
     the same with pe and roi_align re-run in float32 under matmul
     precision 'highest', both under 1e-4; then `run_val_eval` on two of
     the eval phase's scenes (metrics finite); launches are 4 forwards x
     K1 3, K2 9, K3 1, K4 12, mask_bits 2;
     stages: the stage benches (`tools.{stage_bench, detect_stage_bench,
     roi_stage_bench, train_stage_bench, micro_bench, misc_bench,
     train_bench}`) at MV2D-T R50's full width, each `main` with 2 timed
     calls after 1 warm-up: every row's host ms, device-busy ms (a
     profiled window) and host syncs with their blocked ms by
     `mv2d_tpu_torch` site (one profiled call under the sync debug mode)
     printed, finite and positive; the forward's stage rows summing to
     within
     STAGE_SUM_SHARE of its full row; then `stage_bench --check`, each
     stage of the bf16 forward against the float32 plain path on the
     host, both fed the same inputs (backbone C2-C5, FPN p2-p6, the neck,
     the RPN's dense outputs, the R-CNN, the PE of each frame, the
     two-frame head), each row within 3e-2 of its reference's max or,
     where ROADMAP.md's queue C records it, its FAULT_BOUNDS; each row's
     float32 control on the card within 1e-4; the witness (the DCN layers
     and the head with K2 / K4 and with their plain versions in bf16),
     each kernel's error within WITNESS_RATIO of its plain version's;
     launches of the eval and training paths' kernels (`train_stage_bench`
     with --no-remat: the step that `train` runs);
  9. train: four full-width MV2D-T R50 training steps (bf16 mixed
     precision, synthetic_train_batch(seed=0), seeded weights; the first
     is warm-up): finite losses, total and grad norm, trained parameters
     moved and frozen ones not, each training kernel's launches per step,
     ms per step and peak memory, and the inputs each training kernel saw
     first replayed through its plain version; train_s: four full-width
     MV2D-S R50 steps (roi key mode, no DN: keys [834, 343, 256] a query
     set each; K3, B9, K4 and B8 on the self-attention), then two with
     DN (40866 shared keys, 1794 queries: K4 and B8 on the cross-
     attention too): finite losses, the DN terms in the second leg only,
     each leg's launches, ms a step and peak memory, the DN cross-
     attention's first inputs replayed; train_remat: two full-width
     MV2D-T R50 steps with remat and remat_decoder against two without,
     the same seeded weights, scene and generator (dropout 0.1), cuDNN
     held to deterministic algorithms for the phase: every metric and
     gradient equal bit for bit, the remat leg launching B5 and K4 twice
     a step (the backward's recompute) and every other kernel as often,
     ms a step and the peak memory of each leg;
  10. routes_tiny: the routes that the JAX package's switches select
     (`mv2d_tpu_torch.routes.Routes`), float32 with TF32 off, GPU against
     CPU: a ResNet-50 backbone with MV2D-T's DCN layout on 2 views at
     256x704 with fused_stages='all' (MV2D_FUSED_STAGES=all; B10 on
     layer2's tail, and not while gradients are recorded), one tiny+DCN
     training step with dcn_train_fused and flash_sparse
     (MV2D_DCN_TRAIN_FUSED=1, MV2D_FLASH_SPARSE=1; K2, B13 and B8, which
     answers the sparse route; B5 and B6's wrappers not called: B13 runs
     B6's walk inside its own C entry), and one with align_v2
     (MV2D_ALIGN_V2=1; B11 and B9, K3 not launched), every loss and
     gradient;
  11. routes: at full width, two bf16 eval forwards with fused_stages='all'
     and three training steps with the three training routes (B13, B8
     on the sparse attention route, and B11 with B9 for the R-CNN RoIAlign): finite outputs,
     launches, ms and peak memory beside the default route's from phases
     6 and 9, and the first inputs of each new kernel replayed through its
     plain version;
  12. train_cli: the training CLI (`mv2d_tpu_torch.tools.train` `main`)
     on 4 train and 2 val scenes of the rendered fixture (1600x900, two
     epochs, the eval hook after each), MV2D-T R50 from the model's own
     initialisation under seed 0: leg A stops at --max-steps 4 (epoch 1),
     leg B runs --auto-resume with RANK=0 WORLD_SIZE=1 set (an NCCL group
     of one: the dp step's all-reduces on the card).  Checks: 8 log lines
     with every key of the JAX CLI's soak log, finite; the lr of step 5 is
     cosine_schedule(4, ...); the AdamW state that leg B restored equals
     epoch_1.pth's bit for bit; the frozen parameters of epoch_2.pth equal
     the initial ones and the trained ones moved; launches are 8 steps x
     the train phase's per-step counts (K3 2) plus 4 eval scenes x K1 3,
     K2 9, K3 1, K4 12, mask_bits 2, B10-B13 0; `tools.test` on
     epoch_2.pth (strict load) gives the hook's last mAP and NDS, and its
     scene-0 records equal a forward of the hook's bf16 copy within 1e-6.
     Logs ms a step in the CLI loop (1000 / sps) and peak memory;
  13. tools: `tools.get_flops` at full width (params, GFLOPs, bytes),
     `tools.benchmark --bf16` (5 + 20 iterations), `tools/dist_test.sh`
     with GPUS=1 (torchrun, NCCL) on the eval phase's scenes and weights
     (its submission equal to that phase's), `tools.misc publish` and
     `fuse_conv_bn` on train_cli's last checkpoint, each loaded by
     `tools.test`, `tools.visualize --cameras` to a PNG, and
     `utils.profiling.trace` around one forward (device time under each
     operator).
The default phases (3-6, 9) build their models with the default routes
(`Routes()`), whatever the environment holds; phase 7 sets align_v2 for
its R50 server and the default routes for its R101 server; phase 8's
`tools/test.py` reads the routes from the environment, as a user's run
does, and expects none set.  Each path's launch
counters are set to 0 just before it and read just after.  A counter
counts its wrapper's calls.  On CUDA the two-stage detector's `detect`
runs as a CUDA graph: a replay runs its kernels (K3 or B11, the NMS)
without calling a wrapper, and the call that captures calls each wrapper
twice (its warm-up, then the capture), so each path's expected counts
take the `detect_graph` captures and replays of its calls into account
(`expect_calls`), logged beside them; serve and train also count
`detect`'s kernel runs in one more forward or step from the device's own
records (`kernel_runs`, torch.profiler, replays included).  Then one JSON
line with the kernels' results, the card's name and power limit, and the
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 1e-4
BF16_TOL = 3e-2
# the port against itself on the same inputs: float32 rounding of records
SELF_TOL = 1e-6

KERNELS = {
    'fused_stage1': dict(
        op='mv2d::bottleneck',
        source='mv2d_tpu_torch/csrc/stage1.cu',
        replaces='mv2d_tpu/ops/pallas_stage.py:201'),
    'dcn_conv': dict(
        op='mv2d::dcn_conv',
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:607'),
    'roi_align_multilevel': dict(
        op='mv2d::roi_align',
        source='mv2d_tpu_torch/csrc/roi_align.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1263'),
    'masked_attention': dict(
        op='mv2d::masked_attention',
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='mv2d_tpu/ops/pallas_attention.py:179 and :78'),
    'dcn_samples': dict(
        op='mv2d::dcn_samples',
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:575'),
    'dcn_samples_backward': dict(
        op='mv2d::dcn_samples_bwd',
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:378'),
    'masked_attention_backward': dict(
        op='mv2d::masked_attention_bwd',
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='mv2d_tpu/ops/pallas_attention.py:328 and :491'),
    'roi_align_multilevel_backward': dict(
        op='mv2d::roi_align_bwd',
        source='mv2d_tpu_torch/csrc/roi_align.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1524'),
    'fused_identity_chain': dict(
        op='mv2d::identity_block',
        source='mv2d_tpu_torch/csrc/stage.cu',
        replaces='mv2d_tpu/ops/pallas_stage.py:201 (fused_identity_chain '
                 ':253)'),
    'dcn_conv_backward': dict(
        op='mv2d::dcn_conv_bwd',
        source='mv2d_tpu_torch/csrc/dcn.cu',
        replaces='mv2d_tpu/ops/pallas_dcn.py:306'),
    'roi_align_slab': dict(
        op='mv2d::roi_align_slab',
        source='mv2d_tpu_torch/csrc/roi_align_slab.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:1219'),
    'roi_align_flat': dict(
        op='mv2d::roi_align_flat',
        source='mv2d_tpu_torch/csrc/roi_align_patch.cu',
        replaces='mv2d_tpu/ops/pallas_roi_align.py:456'),
    'mask_bits': dict(
        op='mv2d::mask_bits',
        source='mv2d_tpu_torch/csrc/attention.cu',
        replaces='none: packs the mask that K4 and B8 read (the TPU kernels '
                 'take a bf16 mask and per-tile lists, '
                 'mv2d_tpu/ops/pallas_attention.py:192 _sparse_blocks)'),
    'nms_keep': dict(
        op='mv2d::nms_keep',
        source='mv2d_tpu_torch/csrc/nms.cu',
        replaces='none: greedy 2D NMS, which the JAX package runs as a '
                 'blocked scan with a while_loop fixpoint '
                 '(mv2d_tpu/core/nms.py), no pallas_call'),
}
# kernels that only the routing switches and other entry points reach:
# none on the default paths
ROUTED_KERNELS = ('fused_identity_chain', 'dcn_conv_backward',
                  'roi_align_slab', 'roi_align_flat')
# the decoder packs its self- and cross-attention masks once a pass
MASKS_PER_PASS = 2
# NMS launches a pass of the two-stage detector's detect: the RPN's and the
# R-CNN's; a training step adds the proposals the R-CNN samples from
NMS_PER_DETECT = 2
# a two-stage detect's kernel launches on the default routes (K3 on the
# R-CNN's RoIs, the NMS twice).  On CUDA `detect` runs as a CUDA graph: a
# replay runs them without calling a wrapper (so no wrapper counts them),
# and the call that captures calls each wrapper twice (`expect_calls`);
# the device's own records count their runs (`kernel_runs`)
DETECT_CALLS = {'roi_align_multilevel': 1, 'nms_keep': NMS_PER_DETECT}
# with align_v2, detect's RoIs go through B11
DETECT_CALLS_V2 = {'roi_align_slab': 1, 'nms_keep': NMS_PER_DETECT}
# wrapper -> the kernel whose runs the profiler counts (one a launch)
DETECT_KERNEL_NAMES = {'roi_align_multilevel': 'roi_align_kernel',
                       'nms_keep': 'nms_sweep_kernel'}
# launches per training step (K1: 3 bottlenecks; K3: at least the no-grad
# detect pass and the R-CNN RoIs)
TRAIN_PER_STEP = {'fused_stage1': 3, 'dcn_samples': 9,
                  'dcn_samples_backward': 9, 'masked_attention': 12,
                  'masked_attention_backward': 12,
                  'roi_align_multilevel_backward': 1,
                  'mask_bits': MASKS_PER_PASS, 'nms_keep': NMS_PER_DETECT + 1,
                  **{n: 0 for n in ROUTED_KERNELS}}
# launches per training step with the dcn_train_fused, flash_sparse and
# align_v2 routes (K2: the nine DCN convs' forwards; B13 their backwards,
# with B6's walk inside its own C entry, so B6's wrapper counts none; B8
# answers the sparse attention's backward; B11: the detect pass and the
# R-CNN RoIs)
ROUTED_TRAIN_PER_STEP = {'fused_stage1': 3, 'dcn_conv': 9,
                         'dcn_conv_backward': 9, 'dcn_samples': 0,
                         'dcn_samples_backward': 0, 'masked_attention': 12,
                         'masked_attention_backward': 12,
                         'roi_align_multilevel': 0, 'roi_align_slab': 2,
                         'roi_align_multilevel_backward': 1,
                         'fused_identity_chain': 0, 'roi_align_flat': 0,
                         'mask_bits': MASKS_PER_PASS,
                         'nms_keep': NMS_PER_DETECT + 1}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12            # outside the tensor cores


# what a phase leaves for a later one (the eval fixture, the training
# CLI's checkpoint) and the temporary directories to remove at the end
KEEP = {}


def counters():
    """Kernel name -> the wrapper that holds its launch counter."""
    from mv2d_tpu_torch.ops import attention, dcn, nms, roi_align, stage
    return {'fused_stage1': stage.fused_stage1, 'dcn_conv': dcn.dcn_conv,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'masked_attention': attention.masked_attention,
            'dcn_samples': dcn.dcn_samples_forward,
            'dcn_samples_backward': dcn.dcn_samples_backward,
            'masked_attention_backward':
                attention.masked_attention_backward,
            'roi_align_multilevel_backward':
                roi_align.roi_align_multilevel_backward,
            'fused_identity_chain': stage.fused_identity_chain,
            'dcn_conv_backward': dcn.dcn_conv_backward,
            'roi_align_slab': roi_align.roi_align_slab,
            'roi_align_flat': roi_align.roi_align_flat,
            'mask_bits': attention.mask_bits, 'nms_keep': nms.nms_keep}


def log(*a):
    print(*a, flush=True)


def detect_graph_calls(since=None):
    """The detect CUDA graph's captures and replays (`profiling.counters`)
    since the snapshot `since` (a dict, from `detect_graph_calls()`)."""
    from mv2d_tpu_torch.utils.profiling import counters as program
    since = since or {}
    return {k: program[f'detect_graph.{k}'] - since.get(k, 0)
            for k in ('captures', 'replays')}


def expect_calls(per_pass, n, graph, detect=None):
    """Each wrapper's calls in n passes of `per_pass` eager calls each,
    where the passes' two-stage `detect` captured and replayed as `graph`
    says (`detect_graph_calls`): a replay runs `detect`'s kernels
    (`detect`, default DETECT_CALLS) and calls no wrapper, and the call
    that captures calls each wrapper twice (its warm-up, then the
    capture, which runs nothing)."""
    detect = DETECT_CALLS if detect is None else detect
    extra = graph['captures'] - graph['replays']
    return {k: c * n + detect.get(k, 0) * extra for k, c in per_pass.items()}


def kernel_runs(fn):
    """fn() under torch.profiler -> (the runs of `detect`'s kernels that
    the device recorded, by wrapper (DETECT_KERNEL_NAMES), graph replays
    included; fn's result)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    runs = {k: 0 for k in DETECT_KERNEL_NAMES}
    for e in prof.key_averages():
        for k, kernel in DETECT_KERNEL_NAMES.items():
            if re.search(rf'\b{kernel}\b', e.key):
                runs[k] += e.count
    return runs, out


def time_ms(fn, n=5):
    import torch
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


def compare(kernel_out, plain_out):
    """(max abs error, max abs error / max |plain|, finite)."""
    k = kernel_out.float()
    p = plain_out.float()
    err = (k - p).abs().max().item()
    scale = max(p.abs().max().item(), 1e-6)
    return err, err / scale, bool(torch_isfinite(k))


def torch_isfinite(t):
    import torch
    return torch.isfinite(t).all().item()


def compare_all(kernel_outs, plain_outs):
    """compare() over paired tensors: (worst abs error, worst relative
    error, all finite, shapes equal)."""
    errs = [compare(k, p) for k, p in zip(kernel_outs, plain_outs)]
    same = len(kernel_outs) == len(plain_outs) and all(
        k.shape == p.shape for k, p in zip(kernel_outs, plain_outs))
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs), same)


def cotangent(like, seed=7):
    """A seeded N(0, 1) cotangent of `like`'s shape, dtype and device."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn(like.shape, generator=g).to(like.device, like.dtype)


def plain_grads(fn, args, diff, cot):
    """(output, gradients of <output, cot> w.r.t. args[i] for i in diff)
    through fn's autograd; the other args pass through unchanged."""
    import torch
    leaves = list(args)
    for i in diff:
        leaves[i] = args[i].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = fn(*leaves)
        grads = torch.autograd.grad(out, [leaves[i] for i in diff], cot,
                                    allow_unused=True)
    # an input the function never read (a RoIAlign level no RoI routes
    # to) has a zero gradient
    return out.detach(), [torch.zeros_like(leaves[i]) if g is None
                          else g.detach() for i, g in zip(diff, grads)]


# ----------------------------------------------------------- kernel inputs

def stage1_inputs(dev, dtype, V=12, H=128, W=352, seed=0):
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.synthetic import init_random_weights
    g = torch.Generator().manual_seed(seed)
    net = init_random_weights(ResNet(50), seed)
    with torch.no_grad():
        for m in net.layer1.modules():     # random frozen-BN statistics
            if hasattr(m, 'running_var'):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
        blocks = [{k: v.to(dev) for k, v in blk.folded().items()}
                  for blk in net.layer1]
    x = torch.randn(V, H, W, 64, generator=g).relu().to(dev, dtype)
    return x, blocks


def identity_chain_inputs(dev, dtype, V=12, H=64, W=176, stage=1,
                          seed=0):
    """x [V, H, W, 4P] and the folded identity blocks 1..n-1 of stage
    `stage` (P = 64 * 2**stage) of a seeded ResNet-50 with random frozen-BN
    statistics."""
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.synthetic import init_random_weights
    g = torch.Generator().manual_seed(seed)
    layer = getattr(init_random_weights(ResNet(50), seed), f'layer{stage + 1}')
    with torch.no_grad():
        for m in layer.modules():
            if hasattr(m, 'running_var'):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
        blocks = [{k: v.to(dev) for k, v in blk.folded().items()}
                  for blk in layer[1:]]
    x = torch.randn(V, H, W, blocks[0]['w1'].shape[0],
                    generator=g).relu().to(dev, dtype)
    return x, blocks


def dcn_inputs(dev, dtype, V, H, W, C, F, stride, seed=0, far=0.0):
    """Sample coordinates around the 3x3 stride grid with N(0, 2) offsets;
    a `far` share of them moved well outside the map."""
    import torch
    g = torch.Generator().manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ys = torch.arange(Ho) * stride - 1.0
    xs = torch.arange(Wo) * stride - 1.0
    k = torch.arange(3.0)
    by = (ys[:, None, None] + k.repeat_interleave(3)[None, None]) \
        .expand(Ho, Wo, 9)
    bx = (xs[None, :, None] + k.repeat(3)[None, None]).expand(Ho, Wo, 9)
    sy = by[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    sx = bx[None] + 2 * torch.randn(V, Ho, Wo, 9, generator=g)
    if far:
        jump = torch.rand(V, Ho, Wo, 9, generator=g) < far
        sy = torch.where(jump, sy + (H + 50) * torch.sign(
            torch.randn(V, Ho, Wo, 9, generator=g)), sy)
        sx = torch.where(jump, sx - (W + 80), sx)
    mask = torch.rand(V, Ho, Wo, 9, generator=g)
    x = torch.randn(V, H, W, C, generator=g)
    w = torch.randn(9, C, F, generator=g) * (9 * C) ** -0.5
    return (x.to(dev, dtype), sy.to(dev).contiguous(),
            sx.to(dev).contiguous(), mask.to(dev), w.to(dev, dtype))


def attention_inputs(dev, dtype, Q=900, K=16384, C=256, seed=0,
                     self_attn=False):
    """Projected q/k/v and a correlation-like mask: each query sees a few
    contiguous key runs (~3% of keys); 10% of the rows see nothing."""
    import torch
    g = torch.Generator().manual_seed(seed)
    if self_attn:
        K = Q
        valid = torch.rand(K, generator=g) < 0.8
        allowed = valid[None, :] | torch.eye(Q, dtype=torch.bool)
    else:
        allowed = torch.zeros(Q, K, dtype=torch.bool)
        starts = torch.randint(0, K - 600, (Q, 3), generator=g)
        lens = torch.randint(50, 300, (Q, 3), generator=g)
        ar = torch.arange(K)
        for j in range(3):
            allowed |= (ar[None] >= starts[:, j:j + 1]) & \
                (ar[None] < starts[:, j:j + 1] + lens[:, j:j + 1])
        allowed[torch.rand(Q, generator=g) < 0.1] = False
    q = torch.randn(Q, C, generator=g)
    k = torch.randn(K, C, generator=g)
    v = torch.randn(K, C, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            allowed.to(dev))




def train_attention_inputs(dev, dtype, self_attn=False, Q=2628, K=16384,
                           C=256, dn=960, G=96, seed=0):
    """The training decoder's attention at full width: Q = 960 DN rows +
    12 * (75 + 64) queries.  Cross: DN rows see every valid key (85%; the
    rest are keys no row may attend), the others a few correlated runs,
    10% of them none.  Self: the DN block mask (DN groups of 96 see
    themselves, match queries no DN row, 80% of slots valid)."""
    import torch
    from types import SimpleNamespace
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    g = torch.Generator().manual_seed(seed)
    if self_attn:
        K = Q
        cfg = configs.mv2d_t_r50()
        host = SimpleNamespace(cfg=cfg)
        valid = torch.rand(Q, generator=g) < 0.8
        allowed = MV2D._dn_self_mask(host, valid[dn:], valid[:dn])
    else:
        key_ok = torch.rand(K, generator=g) < 0.85
        _, _, _, runs = attention_inputs('cpu', torch.float32, Q=Q - dn, K=K,
                                         C=8, seed=seed)
        allowed = torch.cat([key_ok[None].expand(dn, K), runs & key_ok])
    q = torch.randn(Q, C, generator=g)
    k = torch.randn(K, C, generator=g)
    v = torch.randn(K, C, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            allowed.to(dev))


def nms_inputs(dev, shape, kind='random', dtype=None, seed=0,
               image=(512, 1408)):
    """Score-ordered boxes [*shape, 4] (x1, y1, x2, y2) in an image of
    `image` (h, w) and their validity [*shape] for the NMS kernel, in
    `dtype` (float32 by default; bfloat16 boxes are the dtype itself,
    'bf16_derived' float32 boxes rounded through bfloat16 as the eval
    path's are).  kind: 'random' (anchor-like boxes at random, 10%
    invalid), 'clustered' (boxes around a few dozen centres: long runs of
    overlaps, as the RPN's top scores give), 'duplicates' (each box
    repeated two to four times in a row), 'invalid' (the first row all
    invalid), 'chain' (runs in which each box overlaps the next by IoU
    0.79 and the one after by 0.62: greedy keeps every other box)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    *lead, N = shape
    R = int(np.prod(lead)) if lead else 1
    H, W = image
    if kind == 'clustered':
        c = torch.rand(R, 24, 2, generator=g) * torch.tensor([W, H])
        pick = torch.randint(0, 24, (R, N), generator=g)
        ctr = torch.gather(c, 1, pick[..., None].expand(R, N, 2)) \
            + torch.randn(R, N, 2, generator=g) * 6
        wh = torch.rand(R, N, 2, generator=g) * 120 + 16
    else:
        ctr = torch.rand(R, N, 2, generator=g) * torch.tensor([W, H])
        wh = (torch.rand(R, N, 2, generator=g) * 2 - 1).exp() * 64
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = torch.minimum(boxes.clamp(min=0), torch.tensor([W, H, W, H]))
    if kind == 'duplicates':
        rep = torch.randint(2, 5, (N,), generator=g)
        idx = torch.repeat_interleave(torch.arange(N), rep)[:N]
        boxes = boxes[:, idx]
    if kind == 'chain':
        # box i spans [2i, 2i + 17] in its run of 200
        i = torch.arange(N, dtype=torch.float32)
        x0 = (i % 200) * 2.0 + (i // 200) * 1000.0
        row = torch.stack([x0, torch.zeros(N), x0 + 17.0,
                           torch.full((N,), 10.0)], -1)
        boxes = row.expand(R, N, 4).clone()
    valid = torch.rand(R, N, generator=g) >= 0.1
    if kind == 'chain':
        valid[:] = True
    if kind == 'invalid':
        valid[0] = False
    if dtype == 'bf16_derived':
        boxes = boxes.to(torch.bfloat16).float()
    elif dtype is not None:
        boxes = boxes.to(dtype)
    return (boxes.reshape(*lead, N, 4).to(dev),
            valid.reshape(*lead, N).to(dev))


def nms_work(R, N):
    """(bytes, bf16-peak-equivalent operations) of the NMS kernel on R
    rows of N boxes: the boxes and validity read, the keep mask written,
    the pair words written and read once; 13 float32 operations (one a
    division) a pair of the upper triangle, at the float32 peak."""
    pairs = R * N * (N - 1) / 2.0
    words = R * N * (-(-N // 64) + 1) / 2.0 * 8
    return (R * N * 18.0 + 2 * words,
            pairs * 13 * BF16_OPS_PER_S / F32_OPS_PER_S)


# ------------------------------------------------------------ kernel cases

class Case:
    """One kernel case: `kernel()` and `plain()` give the results to
    compare (a tensor or a sequence of tensors), `work` = (bytes, ops) of
    the function for its bound, `library()` one PyTorch call computing the
    same function (timed only), or None; `extra` names further calls timed
    beside them (the default route's kernels for the same work, the
    per-pass build around a kernel, single launches of a chain, or a
    yardstick the port never runs); an `exact` case must equal its plain
    version bit for bit; `note` ends its line: a string, or a function of
    the kernel's measured ms (None where the case is not timed)."""

    def __init__(self, kernel, plain, work, library=None, extra=None,
                 exact=False, note=''):
        self.kernel, self.plain = kernel, plain
        self.work, self.library = work, library
        self.extra = extra or {}
        self.exact = exact
        self.note = note


def nbytes(*tensors):
    return float(sum(t.numel() * t.element_size() for t in tensors))


def bound(work):
    """(bound_ms, bound_by) of (bytes, operations) at the H100's peaks."""
    b, ops = work
    t_b, t_o = b / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def as_list(x):
    import torch
    return [x] if torch.is_tensor(x) else list(x)


def roi_samples(rois, feats, strides, sampling_ratio=0):
    """Bilinear samples RoIAlign takes for these RoIs (adaptive ceil(bin),
    or a fixed ratio)."""
    import torch
    from mv2d_tpu_torch.ops.roi_align import roi_levels
    if sampling_ratio > 0:
        return float(rois[..., 0].numel()) * 49 * sampling_ratio ** 2
    lvl = roi_levels(rois.float())
    scale = 1.0 / torch.tensor(strides, device=rois.device)[lvl]
    ext = (rois[..., 2:] - rois[..., :2]).float() * scale[..., None] / 7
    n = torch.ceil(ext).clamp(min=0)
    return float((n[..., 0] * n[..., 1]).sum()) * 49


def _axis_cells(lo, extent, sampling_ratio, n):
    """One axis of each RoI as the RoIAlign kernels read it (`Axis` in
    csrc/roi_axis.cuh): lo, extent [N] in cells of a level n cells long ->
    (first, last) [N] cells its samples inside (-1, n) touch, each sample
    clamped to [0, n - 1] and taking its cell and the next; first > last
    where no sample lies inside."""
    import torch
    bin_ = extent / 7
    if sampling_ratio > 0:
        ns = torch.full_like(bin_, float(sampling_ratio))
    else:
        ns = torch.ceil(bin_).clamp(min=0)
    m = max(int(ns.max()), 1)           # at least one slot (masked off)
    s = torch.arange(m, device=lo.device, dtype=torch.float32)
    i = torch.arange(7, device=lo.device, dtype=torch.float32)
    div = ns.clamp(min=1)[:, None, None]
    p = (lo[:, None, None] + (i[None, :, None] + (s + 0.5) / div) *
         bin_[:, None, None]).flatten(1)
    ok = (s < ns[:, None, None]).expand(-1, 7, -1).flatten(1) & \
        (p > -1.0) & (p < n)
    inf = torch.tensor(float('inf'), device=lo.device)
    first = torch.where(ok, p, inf).amin(1).clamp(0, n - 1)
    last = torch.where(ok, p, -inf).amax(1).clamp(0, n - 1)
    first, last = first.floor().long(), (last.floor().long() + 1).clamp(
        max=n - 1)
    empty = ~ok.any(1)
    return first.masked_fill(empty, 1), last.masked_fill(empty, 0)


def roi_read_bytes(feats, rois, views, strides, sampling_ratio=0):
    """The bytes of the levels RoIAlign must read for these RoIs: per
    (view, level), the union of the footprints (the cells their samples
    touch) of the RoIs routed there, each cell once."""
    import torch
    from mv2d_tpu_torch.ops.roi_align import roi_levels
    rois = rois.reshape(-1, 4).float()
    views = views.reshape(-1).long()
    lvl = roi_levels(rois, len(feats))
    cells = 0
    for l, f in enumerate(feats):
        V, H, W = f.shape[:3]
        b = rois[lvl == l] / strides[l]
        if not b.numel():
            continue
        y0, y1 = _axis_cells(b[:, 1] - 0.5, b[:, 3] - b[:, 1],
                             sampling_ratio, H)
        x0, x1 = _axis_cells(b[:, 0] - 0.5, b[:, 2] - b[:, 0],
                             sampling_ratio, W)
        keep = (y0 <= y1) & (x0 <= x1)
        v = views[lvl == l][keep]
        y0, y1, x0, x1 = y0[keep], y1[keep] + 1, x0[keep], x1[keep] + 1
        # each footprint +1 on a difference grid, summed up both axes
        d = torch.zeros((V, H + 1, W + 1), dtype=torch.int32,
                        device=rois.device)
        for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                             (y1, x1, 1)):
            d.index_put_((v, yy, xx), torch.full_like(v, sign,
                                                      dtype=torch.int32),
                         accumulate=True)
        cells += int((d.cumsum(1).cumsum(2)[:, :H, :W] > 0).sum())
    return float(cells * feats[0].shape[-1] * feats[0].element_size())


def kernel_cases():
    """(kernel name, case label, main-path shape?, build(dev, dtype) ->
    Case)."""
    import torch
    import torch.nn.functional as F
    from mv2d_tpu_torch import synthetic
    from mv2d_tpu_torch.ops import attention, dcn, roi_align, stage

    def stage1(V=12, H=128, W=352):
        def build(dev, dt):
            x, blocks = stage1_inputs(dev, dt, V, H, W)
            # packed as nn.resnet hands them to the kernel
            blocks = [stage.pack_block(b, dt) for b in blocks]
            N = x.shape[0] * x.shape[1] * x.shape[2]
            macs = sum(w.numel() for blk in blocks for k, w in blk.items()
                       if k.startswith('w'))
            y = stage.bottleneck_plain(x, blocks[0])
            # the chain's form, one launch per bottleneck, must read each
            # launch's input and write its output: x + 5 x 256-channel maps
            floor = bound((nbytes(x) * 21 + macs * 2, 2.0 * N * macs))[0]

            def note(ms):
                return f'  three-launch floor {floor:.3f} ms' + (
                    f' ({floor / ms:.1%} of the kernel)' if ms else '')
            return Case(lambda: stage.fused_stage1(x, blocks),
                        lambda: stage.fused_stage1_plain(x, blocks),
                        (nbytes(x) * 5 + macs * 2, 2.0 * N * macs),
                        extra={'block0_ms': lambda: stage.bottleneck_cuda(
                                   x, blocks[0]),
                               'identity_ms': lambda: stage.bottleneck_cuda(
                                   y, blocks[1])},
                        note=note)
        return build

    def identity_chain(V, H, W, stage_index, repeat=False):
        def build(dev, dt):
            x, blocks = identity_chain_inputs(dev, dt, V, H, W, stage_index)
            N = x.shape[0] * x.shape[1] * x.shape[2]
            macs = sum(w.numel() for blk in blocks for k, w in blk.items()
                       if k.startswith('w'))
            planes = blocks[0]['w1'].shape[1]
            th, tw, smem = stage.identity_block_plan(planes)
            tiles = V * -(-H // th) * -(-W // tw)
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            note = (f'  bf16 tile {th}x{tw}, {smem / 1024:.1f} KB shared a '
                    f'block, {tiles} tiles on {min(tiles, sms)} blocks')

            def kernel():
                return stage.fused_identity_chain(x, blocks)

            def cudnn():            # the unfused chain B10 replaces
                return stage.fused_identity_chain_plain(x, blocks)
            # `repeat`: a second run of the kernel, to be equal bit for bit
            return Case(kernel, kernel if repeat else cudnn,
                        (nbytes(x) * 2 + macs * x.element_size(),
                         2.0 * N * macs), library=cudnn, exact=repeat,
                        note=note)
        return build

    def dcn_conv(V, H, W, C, F_, s, far=0.0, integer=False, per_forward=0):
        def build(dev, dt):
            x, sy, sx, m, w = dcn_inputs(dev, dt, V, H, W, C, F_, s, far=far)
            if integer:                 # zero offsets: integer coordinates
                sy, sx = sy.round(), sx.round()
            args = (x, sy, sx, m, w)
            N = sy.numel() // 9

            def b5_matmul():            # a yardstick the port never runs
                smp = dcn.dcn_samples_forward(x, sy, sx, m)
                return smp.reshape(N, -1) @ w.reshape(-1, F_)
            return Case(lambda: dcn.dcn_conv(*args),
                        lambda: dcn.dcn_conv_plain(*args),
                        (nbytes(x, sy, sx, m, w) + N * F_ * x.element_size(),
                         2.0 * N * 9 * C * F_),
                        extra={'b5_matmul_ms': b5_matmul} if per_forward
                        else None,
                        note=f'  {per_forward} a forward' if per_forward
                        else '')
        return build

    def samples_args(dev, dt, V, H, W, C, s, far, integer, pile=False):
        x, sy, sx, m, _ = dcn_inputs(dev, dt, V, H, W, C, 64, s, far=far)
        if integer:                     # zero offsets: integer coordinates
            sy, sx = sy.round(), sx.round()
        if pile:                        # every in-map sample on one cell
            inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
            sy = torch.where(inside, torch.full_like(sy, 5.25), sy)
            sx = torch.where(inside, torch.full_like(sx, 7.5), sx)
        return x, sy.contiguous(), sx.contiguous(), m

    def dcn_fwd(V, H, W, C, s, far=0.0, integer=False, per_step=0):
        def build(dev, dt):
            x, sy, sx, m = samples_args(dev, dt, V, H, W, C, s, far, integer)
            out_bytes = sy.numel() * C * x.element_size()
            return Case(lambda: dcn.dcn_samples_forward(x, sy, sx, m),
                        lambda: dcn.dcn_samples_plain(x, sy, sx, m),
                        (nbytes(x, sy, sx, m) + out_bytes,
                         8.0 * sy.numel() * C),
                        note=f'  {per_step} a step' if per_step else '')
        return build

    def dcn_bwd(V, H, W, C, s, far=0.0, integer=False, pile=False,
                per_step=0):
        def build(dev, dt):
            x, sy, sx, m = samples_args(dev, dt, V, H, W, C, s, far, integer,
                                        pile)
            leaves = [t.clone().requires_grad_(True) for t in (x, sy, sx, m)]
            with torch.enable_grad():
                out = dcn.dcn_samples_plain(*leaves)
            g = cotangent(out)
            # dx in x.dtype, as B6 writes it; B6's first form wrote a
            # float32 dx, and its bound counted that
            moved = nbytes(x, sy, sx, m, g) + 3 * nbytes(sy)
            old = bound((moved + x.numel() * 4, 20.0 * sy.numel() * C))[0]
            note = (f'  {per_step} a step;' if per_step else '') + \
                f'  bound with a float32 dx (B6\'s first form) {old:.3f} ms'
            return Case(
                lambda: dcn.dcn_samples_backward(x, sy, sx, m, g),
                lambda: torch.autograd.grad(out, leaves, g,
                                            retain_graph=True),
                (moved + nbytes(x), 20.0 * sy.numel() * C), note=note)
        return build

    def dcn_conv_bwd(V, H, W, C, F_, s, far=0.0, integer=False, pile=False,
                     repeat=False):
        def build(dev, dt):
            x, sy, sx, m, w = dcn_inputs(dev, dt, V, H, W, C, F_, s, far=far)
            if integer:                 # zero offsets: integer coordinates
                sy, sx = sy.round(), sx.round()
            if pile:                    # every in-map sample on one cell
                inside = (sy > -1) & (sy < H) & (sx > -1) & (sx < W)
                sy = torch.where(inside, torch.full_like(sy, 5.25), sy)
                sx = torch.where(inside, torch.full_like(sx, 7.5), sx)
            args = (x, sy.contiguous(), sx.contiguous(), m, w)
            leaves = [t.clone().requires_grad_(True) for t in args]
            with torch.enable_grad():
                out = dcn.dcn_conv_plain(*leaves)
            g = cotangent(out)
            N = sy.numel() // 9
            Ho, Wo = sy.shape[1:3]
            work = dcn.conv_backward_workspace(
                V, H, W, C, Ho, Wo, F_, 0 if dt == torch.float32 else 1)

            def kernel():
                return dcn.dcn_conv_backward(*args, g)

            def fwd_bwd(fn):            # a route's forward and backward
                with torch.enable_grad():
                    return torch.autograd.grad(fn(*leaves), leaves, g)

            def default_route(x_, sy_, sx_, m_, w_):   # B5 + matmul
                smp = dcn.dcn_samples(x_, sy_, sx_, m_)
                return (smp.reshape(N, -1) @ w_.reshape(-1, F_)).reshape(
                    out.shape)
            # dx and dw in the inputs' dtypes, as B13 writes them; `repeat`:
            # a second run of the kernel, to be equal bit for bit
            return Case(
                kernel, kernel if repeat else lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True),
                (nbytes(x, sy, sx, m, w, g) + nbytes(x, w) + 3 * nbytes(sy),
                 4.0 * N * 9 * C * F_),
                extra={'route_fwd_bwd_ms':
                       lambda: fwd_bwd(dcn.dcn_conv_train),
                       'default_route_fwd_bwd_ms':
                       lambda: fwd_bwd(default_route)},
                exact=repeat,
                note=f'  workspace {work / 2 ** 20:.1f} MiB (ds, B6\'s '
                     f'lists, dw\'s split partials)')
        return build

    def roi(edge, V=12, P=1000, img=(512, 1408), sliver=False, c64=False):
        def build(dev, dt):
            feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P, img=img,
                                               edge=edge, sliver=sliver)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, slot_views(rois))
            # the same RoIs on 64 of the channels: a time that barely
            # moves with C says the bytes are not what paces the kernel
            f64 = [f[..., :64].contiguous() for f in feats] if c64 else None
            return Case(
                lambda: roi_align.roi_align_multilevel(feats, rois, strides),
                lambda: roi_align.multilevel_roi_align_plain(feats, rois,
                                                             strides),
                work,
                extra={'c64_ms': lambda: roi_align.roi_align_multilevel(
                    f64, rois, strides)} if c64 else None,
                note=whole_note('', whole))
        return build

    def slot_views(rois):
        """The view of each RoI of rois [V, P, 4], flattened."""
        V, P = rois.shape[:2]
        return torch.arange(V, device=rois.device).repeat_interleave(P)

    def roi_work(feats, rois, views, S=0, inputs=()):
        """((bytes, ops), whole) of a forward RoIAlign over these RoIs: the
        levels' cells their footprints cover, read once per (view, level),
        the RoIs and `inputs` read and the output written once; `whole` is
        the bound in ms with every level read whole, the count these cases
        first used."""
        strides = (4, 8, 16, 32)
        C = feats[0].shape[-1]
        moved = nbytes(rois, *inputs) + \
            rois[..., 0].numel() * 49 * C * feats[0].element_size()
        ops = 8.0 * C * roi_samples(rois, feats, strides, S)
        whole = bound((moved + nbytes(*feats), ops))[0]
        return (moved + roi_read_bytes(feats, rois, views, strides, S),
                ops), whole

    def whole_note(note, whole):
        """`note`, and where the case is timed, its whole-level bound."""
        return lambda ms: note + ('' if ms is None else
                                  f'  bound with the levels read whole '
                                  f'{whole:.3f} ms')

    def stream_note(dt):
        """B11 / B12's plan: the core's boxes, ring, blocks an SM,
        registers and shared memory, as the kernel reports them."""
        p = roi_align.stream_plan(dt)
        return (f'  plan: TMA boxes of 1 row x {p["box_columns"]} columns '
                f'into {p["stages"]} slots of {p["slot_rows"]} rows x '
                f'{p["slot_columns"]} columns, {p["blocks_per_sm"]} blocks '
                f'an SM, {p["registers"]} registers a thread, {p["smem"]} '
                f'bytes of dynamic shared memory a block')

    def slab(edge, V=12, P=1000, repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, rois = synthetic.wide_roi_inputs(dev, dt)
            else:
                feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P,
                                                   edge=edge)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, slot_views(rois))

            def kernel():
                return roi_align.roi_align_slab(feats, rois, strides)
            # `repeat`: a second run of the kernel, to be equal bit for bit
            return Case(
                kernel, kernel if repeat else
                lambda: roi_align.multilevel_roi_align_plain(feats, rois,
                                                             strides),
                work,
                extra={'k3_ms': lambda: roi_align.roi_align_multilevel(
                    feats, rois, strides)},
                exact=repeat,
                note=whole_note(stream_note(dt) if not (
                    edge or repeat or wide) and P == 1000 else '', whole))
        return build

    def flat(S, edge=False, repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, vp = synthetic.wide_roi_inputs(dev, dt)
                rois = vp.reshape(-1, 4)
                views = torch.arange(vp.shape[0], device=dev,
                                     dtype=torch.int32).repeat_interleave(
                                         vp.shape[1])
            else:
                feats, rois, views = synthetic.flat_roi_inputs(dev, dt,
                                                               edge=edge)
                # context: K3 on the same RoIs, 1000 a view
                vp = rois.reshape(feats[0].shape[0], -1, 4)
            strides = (4, 8, 16, 32)
            work, whole = roi_work(feats, rois, views, S, inputs=(views,))

            def kernel():
                return roi_align.roi_align_flat(feats, rois, views, strides,
                                                S)
            return Case(
                kernel, kernel if repeat else
                lambda: roi_align.multilevel_roi_align_flat_plain(
                    feats, rois, views, strides, S),
                work,
                extra={'k3_ms': lambda: roi_align.roi_align_multilevel(
                    feats, vp, strides)},
                exact=repeat,
                note=whole_note(stream_note(dt) if not (
                    edge or repeat or wide) and S == 0 else '', whole))
        return build

    def roi_bwd(edge, V=6, P=512, img=(512, 1408), pile=False,
                repeat=False, wide=False):
        def build(dev, dt):
            if wide:
                feats, rois = synthetic.wide_roi_inputs(dev, dt)
            else:
                feats, rois = synthetic.roi_inputs(dev, dt, V=V, P=P,
                                                   img=img, edge=edge)
            if pile:                    # every RoI the same box (level 1)
                rois[:] = torch.tensor([300.0, 100.0, 420.0, 230.0],
                                       device=rois.device)
            strides = (4, 8, 16, 32)
            C = feats[0].shape[-1]
            leaves = [f.clone().requires_grad_(True) for f in feats]
            with torch.enable_grad():
                out = roi_align.multilevel_roi_align_plain(leaves, rois,
                                                           strides)
            g = cotangent(out)
            ops = 8.0 * C * roi_samples(rois, feats, strides)
            # the level gradients in the features' dtype, as B9 writes
            # them; B9's first form wrote float32 ones, and its bound
            # counted that
            old = bound((nbytes(g, rois) + sum(f.numel() for f in feats) * 4,
                         ops))[0]

            def kernel():
                return roi_align.roi_align_multilevel_backward(
                    feats, rois, g, strides)

            def autograd():             # zeros for a level no RoI reads
                return [torch.zeros_like(f) if d is None else d
                        for f, d in zip(feats, torch.autograd.grad(
                            out, leaves, g, retain_graph=True,
                            allow_unused=True))]
            # `repeat`: a second run of the kernel, to be equal bit for bit
            plain = kernel if repeat else autograd
            # the owners' lists: RoIs a tile, mean and max, p2..p5
            dims = [d for f in feats for d in f.shape[1:3]]
            keys, _, starts = roi_align.roi_owner_lists_plain(
                rois.cpu(), dims, strides)
            n = (starts[1:] - starts[:-1]).float()
            tyn, txn, first, _ = roi_align._owner_tiles(dims, V)
            lists = ', '.join(
                f'{float(p.mean()):.1f}/{int(p.max())}' for p in (
                    n[int(first[l]):int(first[l] + V * tyn[l] * txn[l])]
                    for l in range(4)))
            return Case(kernel, plain, (nbytes(g, rois, *feats), ops),
                        exact=repeat,
                        note=f'  bound with float32 level gradients (B9\'s '
                             f'first form) {old:.3f} ms; {keys.numel()} '
                             f'(RoI, tile) pairs, RoIs a tile p2..p5 '
                             f'mean/max {lists}')
        return build

    def sdpa_args(q, k, v, a, H):
        Q, C = q.shape
        D = C // H

        def heads(t):
            return t.reshape(t.shape[0], H, D).transpose(0, 1)[None]
        return heads(q), heads(k), heads(v), a[None, None]

    def attn(inputs, train=False, per_forward=0):
        def build(dev, dt):
            q, k, v, a = inputs(dev, dt)
            # the decoder packs each mask once a pass (mask_bits' own cases)
            # and every layer's K4 reads the packed form
            tl = attention.mask_tiles(a)
            nnz = float(a.sum())
            note = f'  {int(tl.key_starts[-1])} active 64x64 tile pairs' + (
                f'  {per_forward} a forward' if per_forward else '')
            C = q.shape[1]
            work = (nbytes(q, k, v, *tl) + nbytes(q)
                    + q.shape[0] * 8 * 4, 4.0 * C * nnz)
            sq, sk, sv, sm = sdpa_args(q, k, v, a, 8)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                sq, sk, sv, attn_mask=sm)
            if train:        # K4 with its log-sum-exp, the training forward
                return Case(
                    lambda: attention.masked_attention_forward(q, k, v, a,
                                                               8, tl),
                    lambda: (attention.masked_attention_plain(q, k, v, a, 8),
                             attention.attention_lse_plain(q, k, a, 8)),
                    work, lib, note=note)
            return Case(lambda: attention.masked_attention(q, k, v, a, 8,
                                                           tl),
                        lambda: attention.masked_attention_plain(q, k, v, a,
                                                                 8),
                        work, lib, note=note)
        return build

    def attn_bwd(inputs, sparse=False):
        def build(dev, dt):
            q, k, v, a = inputs(dev, dt)
            tl = attention.mask_tiles(a)
            out, lse = attention.masked_attention_forward(q, k, v, a, 8, tl)
            g = cotangent(out)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            sl = [t.requires_grad_(True) for t in
                  (x.detach().clone() for x in sdpa_args(q, k, v, a, 8)[:3])]
            with torch.enable_grad():
                pout = attention.masked_attention_plain(*leaves, a, 8)
                lout = F.scaled_dot_product_attention(
                    *sl, attn_mask=a[None, None])
            lg = sdpa_args(g, g, g, a, 8)[0]
            nnz = float(a.sum())
            b8 = (lambda: attention.masked_attention_backward(  # noqa: E731
                q, k, v, a, out, lse, g, 8, tl))
            if sparse:       # the MV2D_FLASH_SPARSE route's backward: B8
                rl = [t.clone().requires_grad_(True) for t in (q, k, v)]
                with torch.enable_grad():
                    rout = attention.masked_attention_train(
                        *rl, a, 8, sparse=True, tiles=tl)
                kernel = (lambda: torch.autograd.grad(  # noqa: E731
                    rout, rl, g, retain_graph=True))
            return Case(
                kernel if sparse else b8,
                lambda: torch.autograd.grad(pout, leaves, g,
                                            retain_graph=True),
                (nbytes(q, k, v, out, g, lse, *tl)
                 + 4.0 * (q.numel() + 2 * k.numel()),
                 10.0 * q.shape[1] * nnz),
                lambda: torch.autograd.grad(lout, sl, lg,
                                            retain_graph=True))
        return build

    def eval_attn(self_attn, K=16384):
        return lambda dev, dt: attention_inputs(dev, dt, K=K,
                                                self_attn=self_attn)

    def train_attn(self_attn):
        return lambda dev, dt: train_attention_inputs(dev, dt, self_attn)

    def full_attn(dev, dt):             # every pair allowed
        q, k, v, a = attention_inputs(dev, dt, Q=300, K=2048)
        return q, k, v, torch.ones_like(a)

    def no_attn(dev, dt):               # no pair allowed
        q, k, v, a = attention_inputs(dev, dt, Q=300, K=2048)
        return q, k, v, torch.zeros_like(a)

    def ragged_attn(dev, dt):           # ragged tiles, K < 64 in the last
        return attention_inputs(dev, dt, Q=101, K=1000, C=256)

    def bits(inputs, per_forward=0):
        def build(dev, dt):
            a = inputs(dev, dt)[3]
            Q, K = a.shape
            # mask_tiles_ms: the whole per-pass build, the bits and both
            # tile lists, that K4 and B8's times leave out
            return Case(lambda: attention.mask_bits(a).view(torch.uint8),
                        lambda: attention.mask_bits_plain(a).view(
                            torch.uint8),
                        (nbytes(a) + Q * -(-K // 64) * 8.0, 0.0),
                        exact=True,
                        extra={'mask_tiles_ms':
                               lambda: attention.mask_tiles(a)},
                        note=f'  {per_forward} a forward' if per_forward
                        else '')
        return build

    def nms(shape, kind='random', thr=0.7, box_dtype=None):
        # float32 boxes: rounded through bfloat16 in the bf16 pass, as the
        # eval path's come from bf16 deltas; box_dtype fixes the dtype
        def build(dev, dt):
            from mv2d_tpu_torch.core.nms import greedy_keep_plain
            from mv2d_tpu_torch.ops import nms as nms_op
            bd = box_dtype or ('bf16_derived' if dt == torch.bfloat16
                               else torch.float32)
            b, v = nms_inputs(dev, shape, kind, bd)
            return Case(lambda: nms_op.nms_keep(b, v, thr).to(torch.uint8),
                        lambda: greedy_keep_plain(b, v, thr).to(torch.uint8),
                        nms_work(int(np.prod(shape[:-1])), shape[-1]),
                        exact=True)
        return build

    return [
        ('fused_stage1', 'layer1 [12,128,352,64]', True, stage1()),
        ('fused_stage1', 'R101 layer1 [12,160,400,64]', False,
         stage1(12, 160, 400)),
        ('fused_stage1', 'edge: ragged tiles [3,13,70,64]', False,
         stage1(3, 13, 70)),
        ('fused_stage1', 'edge: under one tile [1,5,7,64]', False,
         stage1(1, 5, 7)),
        ('dcn_conv', 'stage3 s2 [12,64,176,256]', True,
         dcn_conv(12, 64, 176, 256, 256, 2, per_forward=1)),
        ('dcn_conv', 'stage3 s1 [12,32,88,256]', True,
         dcn_conv(12, 32, 88, 256, 256, 1, per_forward=5)),
        ('dcn_conv', 'stage4 s2 [12,32,88,512]', True,
         dcn_conv(12, 32, 88, 512, 512, 2, per_forward=1)),
        ('dcn_conv', 'stage4 s1 [12,16,44,512]', True,
         dcn_conv(12, 16, 44, 512, 512, 1, per_forward=2)),
        ('dcn_conv', 'R101 stage3 s2 [12,80,200,256]', True,
         dcn_conv(12, 80, 200, 256, 256, 2, per_forward=1)),
        ('dcn_conv', 'R101 stage3 s1 [12,40,100,256]', True,
         dcn_conv(12, 40, 100, 256, 256, 1, per_forward=22)),
        ('dcn_conv', 'R101 stage4 s2 [12,40,100,512]', True,
         dcn_conv(12, 40, 100, 512, 512, 2, per_forward=1)),
        ('dcn_conv', 'R101 stage4 s1 [12,20,50,512]', True,
         dcn_conv(12, 20, 50, 512, 512, 1, per_forward=2)),
        ('dcn_conv', 'edge: 20% offsets far outside', False,
         dcn_conv(12, 16, 44, 512, 512, 1, far=0.2)),
        ('dcn_conv', 'edge: integer coordinates', False,
         dcn_conv(12, 16, 44, 512, 512, 1, integer=True)),
        ('dcn_conv', 'edge: ragged N, C 96, F 192 [1,13,21,96]', False,
         dcn_conv(1, 13, 21, 96, 192, 1)),
        ('roi_align_multilevel', 'p2-p5, rois [12,1000,4]', True,
         roi(False, c64=True)),
        ('roi_align_multilevel', 'train rois [6,512,4]', True,
         roi(False, 6, 512)),
        ('roi_align_multilevel', 'edge: extreme aspect/empty/outside',
         False, roi(True)),
        ('roi_align_multilevel', 'R101 p2-p5 1600x640, rois [12,1000,4]',
         True, roi(False, img=(640, 1600))),
        ('roi_align_multilevel', 'edge: slivers 1408x8 and 6x512 [12,200]',
         False, roi(False, P=200, sliver=True)),
        ('masked_attention', 'cross q900 k16384 (10% rows empty)', True,
         attn(eval_attn(False))),
        ('masked_attention', 'R101 cross q900 k48000 (10% rows empty)',
         True, attn(eval_attn(False, 48000), per_forward=6)),
        ('masked_attention', 'self q900 k900', False, attn(eval_attn(True))),
        ('masked_attention', 'train cross q2628 k16384 +lse', True,
         attn(train_attn(False), train=True)),
        ('masked_attention', 'train self q2628 DN mask +lse', False,
         attn(train_attn(True), train=True)),
        ('masked_attention', 'edge: every pair allowed +lse', False,
         attn(full_attn, train=True)),
        ('masked_attention', 'edge: no pair allowed +lse', False,
         attn(no_attn, train=True)),
        ('masked_attention', 'edge: ragged q101 k1000', False,
         attn(ragged_attn)),
        ('dcn_samples', 'stage3 s2 [12,64,176,256]', True,
         dcn_fwd(12, 64, 176, 256, 2, per_step=1)),
        ('dcn_samples', 'stage3 s1 [12,32,88,256]', True,
         dcn_fwd(12, 32, 88, 256, 1, per_step=5)),
        ('dcn_samples', 'stage4 s2 [12,32,88,512]', True,
         dcn_fwd(12, 32, 88, 512, 2, per_step=1)),
        ('dcn_samples', 'stage4 s1 [12,16,44,512]', True,
         dcn_fwd(12, 16, 44, 512, 1, per_step=2)),
        ('dcn_samples', 'edge: 20% offsets far outside', False,
         dcn_fwd(12, 16, 44, 512, 1, far=0.2)),
        ('dcn_samples', 'edge: integer coordinates', False,
         dcn_fwd(12, 16, 44, 512, 1, integer=True)),
        ('dcn_samples', 'edge: ragged tiles [1,13,21,40]', False,
         dcn_fwd(1, 13, 21, 40, 1)),
        ('dcn_samples_backward', 'stage3 s2 [12,64,176,256]', True,
         dcn_bwd(12, 64, 176, 256, 2, per_step=1)),
        ('dcn_samples_backward', 'stage3 s1 [12,32,88,256]', True,
         dcn_bwd(12, 32, 88, 256, 1, per_step=5)),
        ('dcn_samples_backward', 'stage4 s2 [12,32,88,512]', True,
         dcn_bwd(12, 32, 88, 512, 2, per_step=1)),
        ('dcn_samples_backward', 'stage4 s1 [12,16,44,512]', True,
         dcn_bwd(12, 16, 44, 512, 1, per_step=2)),
        ('dcn_samples_backward', 'edge: 20% offsets far outside', False,
         dcn_bwd(12, 16, 44, 512, 1, far=0.2)),
        ('dcn_samples_backward', 'edge: integer coordinates', False,
         dcn_bwd(12, 16, 44, 512, 1, integer=True)),
        ('dcn_samples_backward', 'edge: pile-up, every sample on one cell',
         False, dcn_bwd(12, 16, 44, 512, 1, far=0.2, pile=True)),
        ('dcn_samples_backward', 'edge: ragged [1,13,21,40]', False,
         dcn_bwd(1, 13, 21, 40, 1)),
        ('masked_attention_backward', 'train cross q2628 k16384', True,
         attn_bwd(train_attn(False))),
        ('masked_attention_backward', 'train self q2628 DN mask', False,
         attn_bwd(train_attn(True))),
        ('masked_attention_backward', 'edge: every pair allowed', False,
         attn_bwd(full_attn)),
        ('masked_attention_backward', 'edge: no pair allowed', False,
         attn_bwd(no_attn)),
        ('masked_attention_backward', 'edge: ragged q101 k1000', False,
         attn_bwd(ragged_attn)),
        ('roi_align_multilevel_backward', 'train rois [6,512,4]', True,
         roi_bwd(False)),
        ('roi_align_multilevel_backward',
         'R101 p2-p5 1600x640, rois [6,512,4]', True,
         roi_bwd(False, img=(640, 1600))),
        ('roi_align_multilevel_backward',
         'edge: 1408x8, 6x512, empty, outside', False, roi_bwd(True)),
        ('roi_align_multilevel_backward',
         'edge: p2 560 cells wide, slivers across it', False,
         roi_bwd(False, wide=True)),
        ('roi_align_multilevel_backward',
         'edge: pile-up, 512 identical rois a view', False,
         roi_bwd(False, pile=True)),
        ('roi_align_multilevel_backward',
         'run to run: two kernel runs, bit for bit', False,
         roi_bwd(False, repeat=True)),
        ('fused_identity_chain', 'layer2 tail P128 [12,64,176,512] x3',
         True, identity_chain(12, 64, 176, 1)),
        ('fused_identity_chain', 'layer3 tail P256 [12,32,88,1024] x5',
         True, identity_chain(12, 32, 88, 2)),
        ('fused_identity_chain', 'edge: ragged tiles P128 [2,13,37,512]',
         False, identity_chain(2, 13, 37, 1)),
        ('fused_identity_chain', 'edge: ragged tiles P256 [2,13,37,1024]',
         False, identity_chain(2, 13, 37, 2)),
        ('fused_identity_chain', 'run to run: two kernel runs, bit for bit',
         False, identity_chain(12, 32, 88, 2, repeat=True)),
        ('dcn_conv_backward', 'stage3 s2 [12,64,176,256]', True,
         dcn_conv_bwd(12, 64, 176, 256, 256, 2)),
        ('dcn_conv_backward', 'stage3 s1 [12,32,88,256]', True,
         dcn_conv_bwd(12, 32, 88, 256, 256, 1)),
        ('dcn_conv_backward', 'stage4 s1 [12,16,44,512]', True,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1)),
        ('dcn_conv_backward', 'edge: 20% offsets far outside', False,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1, far=0.2)),
        ('dcn_conv_backward', 'edge: integer coordinates', False,
         dcn_conv_bwd(12, 16, 44, 512, 512, 1, integer=True)),
        ('dcn_conv_backward', 'edge: pile-up, every sample on one cell',
         False, dcn_conv_bwd(12, 16, 44, 512, 512, 1, far=0.2, pile=True)),
        ('dcn_conv_backward', 'run to run: two kernel runs, bit for bit',
         False, dcn_conv_bwd(12, 32, 88, 256, 256, 1, repeat=True)),
        ('masked_attention_backward', 'sparse route: cross q2628 k16384',
         True, attn_bwd(train_attn(False), sparse=True)),
        ('masked_attention_backward', 'sparse route: self q2628 DN mask',
         True, attn_bwd(train_attn(True), sparse=True)),
        ('masked_attention_backward', 'sparse route: every pair allowed',
         False, attn_bwd(full_attn, sparse=True)),
        ('roi_align_slab', 'p2-p5, rois [12,1000,4]', True, slab(False)),
        ('roi_align_slab', 'train rois [6,512,4]', True,
         slab(False, 6, 512)),
        ('roi_align_slab', 'edge: extreme aspect/empty/outside', False,
         slab(True)),
        ('roi_align_slab', 'edge: p2 560 cells wide, slivers across it',
         False, slab(False, wide=True)),
        ('roi_align_slab', 'run to run: two kernel runs, bit for bit', False,
         slab(False, repeat=True)),
        ('roi_align_flat', '12000 rois, random views, adaptive', True,
         flat(0)),
        ('roi_align_flat', '12000 rois, random views, S=2', True, flat(2)),
        ('roi_align_flat', 'edge: outside/empty/whole/slivers, adaptive',
         False, flat(0, edge=True)),
        ('roi_align_flat', 'edge: outside/empty/whole/slivers, S=2', False,
         flat(2, edge=True)),
        ('roi_align_flat', 'edge: p2 560 cells wide, slivers, adaptive',
         False, flat(0, wide=True)),
        ('roi_align_flat', 'edge: p2 560 cells wide, slivers, S=2', False,
         flat(2, wide=True)),
        ('roi_align_flat', 'run to run: two kernel runs, bit for bit', False,
         flat(0, repeat=True)),
        ('mask_bits', 'train cross [2628,16384]', True,
         bits(train_attn(False))),
        ('mask_bits', 'eval cross [900,16384]', True,
         bits(eval_attn(False))),
        ('mask_bits', 'R101 eval cross [900,48000]', True,
         bits(eval_attn(False, 48000), per_forward=1)),
        ('mask_bits', 'train self [2628,2628]', True,
         bits(train_attn(True))),
        ('mask_bits', 'edge: ragged [101,1000]', False, bits(ragged_attn)),
        ('mask_bits', 'edge: every pair allowed [300,2048]', False,
         bits(full_attn)),
        ('nms_keep', 'RPN [12,5,1000] IoU 0.7', True,
         nms((12, 5, 1000), 'clustered')),
        ('nms_keep', 'R-CNN [12,1000] IoU 0.6', True,
         nms((12, 1000), 'random', 0.6)),
        ('nms_keep', 'train proposals [6,5,2000] IoU 0.7', True,
         nms((6, 5, 2000), 'clustered')),
        ('nms_keep', 'edge: duplicates [12,1000]', False,
         nms((12, 1000), 'duplicates')),
        ('nms_keep', 'edge: a row all invalid [12,1000]', False,
         nms((12, 1000), 'invalid')),
        ('nms_keep', 'edge: suppression chains [4,1000]', False,
         nms((4, 1000), 'chain')),
        ('nms_keep', 'edge: bfloat16 boxes [12,1000]', False,
         nms((12, 1000), 'clustered', box_dtype=torch.bfloat16)),
        ('nms_keep', 'edge: ragged [7,65]', False,
         nms((7, 65))),
        ('nms_keep', 'edge: one box [3,1]', False, nms((3, 1))),
        ('nms_keep', 'edge: words past the stage [2,3000]', False,
         nms((2, 3000), 'clustered')),
    ]


def phase_kernels(dev, results):
    import torch
    ok = True
    for name, label, main, build in kernel_cases():
        for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            case = build(dev, dt)
            out_k, out_p = as_list(case.kernel()), as_list(case.plain())
            torch.cuda.synchronize()
            err, rel, finite, same = compare_all(out_k, out_p)
            good = finite and same and rel <= (0.0 if case.exact else tol)
            ok &= good
            line = (f'  {name:<30} {label:<38} {str(dt)[6:]:<9} '
                    f'max_abs_err={err:.3e} rel={rel:.2e} tol={tol:.0e} '
                    f'{"ok" if good else "FAIL"}')
            ms = None
            if main and dt == torch.bfloat16:
                p1 = time_ms(case.plain)
                k1 = time_ms(case.kernel)
                k2 = time_ms(case.kernel)
                p2 = time_ms(case.plain)
                lib = time_ms(case.library) if case.library else None
                b_ms, b_by = bound(case.work)
                timing = dict(label=label, max_abs_err=err, ms=(k1 + k2) / 2,
                              plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
                for key, fn in case.extra.items():
                    timing[key] = time_ms(fn)
                    line += f'  {key} {timing[key]:.3f}'
                r = results[name]
                if r['ms'] is None:
                    r.update(timing)
                else:
                    r.setdefault('other_shapes', []).append(timing)
                line += (f'  kernel {timing["ms"]:.3f} ms  plain '
                         f'{timing["plain_ms"]:.3f} ms  bound {b_ms:.3f} ms '
                         f'({b_by}, {b_ms / timing["ms"]:.1%} of it)')
                if lib is not None:
                    line += f'  library {lib:.3f} ms'
                ms = timing['ms']
            log(line + (case.note if isinstance(case.note, str)
                        else case.note(ms)))
            del case, out_k, out_p
            torch.cuda.empty_cache()
    return op_overhead(dev, results) and ok


def op_args(dev, dtype=None, seed=0):
    """Each `mv2d` operator's arguments at small shapes that its kernel
    takes (block 0 of layer1 for K1, width 128 for B10, four RoIs a view
    on four levels, 128 queries on 256 keys), in `dtype` (default
    bfloat16) with float32 coordinates and biases."""
    import torch
    from mv2d_tpu_torch.ops import attention, stage
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dtype or torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def block(cin, p, wd):
        blk = dict(w1=rnd(cin, p, scale=0.1), b1=rnd(p, dtype=torch.float32),
                   w2=rnd(9, p, p, scale=0.05),
                   b2=rnd(p, dtype=torch.float32),
                   w3=rnd(p, 4 * p, scale=0.1),
                   b3=rnd(4 * p, dtype=torch.float32))
        if wd:
            blk.update(wd=rnd(cin, 4 * p, scale=0.1),
                       bd=rnd(4 * p, dtype=torch.float32))
        return stage._block_args(blk)

    V, H, W, C, F = 1, 8, 16, 64, 64
    x = rnd(V, H, W, C)
    sy = torch.rand((V, H, W, 9), generator=g, device=dev) * H
    sx = torch.rand((V, H, W, 9), generator=g, device=dev) * W
    m = torch.rand((V, H, W, 9), generator=g, device=dev)
    w = rnd(9, C, F, scale=0.05)
    feats = [rnd(2, 128 // s, 256 // s, 64) for s in (4, 8, 16, 32)]
    rois = torch.tensor([[[4., 4., 40., 30.], [0., 0., 250., 120.],
                          [10., 3., 20., 9.], [60., 20., 180., 110.]]] * 2,
                        device=dev)
    strides = [4, 8, 16, 32]
    Q, K, Cq = 128, 256, 256
    q, k, v = rnd(Q, Cq), rnd(K, Cq), rnd(K, Cq)
    allowed = torch.rand((Q, K), generator=g, device=dev) < 0.3
    tiles = attention.mask_tiles(allowed)
    out, lse = attention.masked_attention_forward(q, k, v, allowed, 8, tiles)
    return {
        'bottleneck': (x, *block(64, 64, True)),
        'identity_block': (rnd(V, H, W, 512), *block(512, 128, False)[:6]),
        'dcn_conv': (x, sy, sx, m, w),
        'dcn_samples': (x, sy, sx, m),
        'dcn_samples_bwd': (x, sy, sx, m, rnd(V, H, W, 9, C)),
        'dcn_conv_bwd': (x, sy, sx, m, w, rnd(V, H, W, F)),
        'roi_align': (feats, rois, strides),
        'roi_align_slab': (feats, rois, strides),
        'roi_align_flat': (feats, rois.reshape(-1, 4),
                           torch.tensor([0] * 4 + [1] * 4, device=dev),
                           strides, 0),
        'roi_align_bwd': (feats, rois, rnd(2, 4, 7, 7, 64), strides),
        'mask_bits': (allowed,),
        'masked_attention': (q, k, v, allowed, *tiles[:3], 8),
        'masked_attention_bwd': (q, k, v, None, *tiles, out, lse,
                                 rnd(Q, Cq), 8),
        'nms_keep': (*nms_inputs(dev, (2, 3, 100), 'random',
                                 dtype or torch.float32, seed), 0.7),
    }


def _host_us(fn, n):
    """Host microseconds a call of fn over n calls (the launches queue on
    the device; it is synchronized before and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def op_overhead(dev, results, n=200):
    """Host microseconds a call of each `mv2d` operator against a direct
    call of its CUDA implementation on the same arguments (in turns:
    direct, op, op, direct), and the cost per eval forward and per
    training step from the launches a path makes (EVAL_PER_FORWARD,
    TRAIN_PER_STEP)."""
    import torch
    from mv2d_tpu_torch.ops import library
    args = op_args(dev)
    per_call = {}
    for name, a in args.items():
        op = getattr(torch.ops.mv2d, name)
        direct = library.OPS[name].cuda
        d1 = _host_us(lambda: direct(*a), n)
        o1 = _host_us(lambda: op(*a), n)
        o2 = _host_us(lambda: op(*a), n)
        d2 = _host_us(lambda: direct(*a), n)
        per_call[name] = dict(op_us=(o1 + o2) / 2, direct_us=(d1 + d2) / 2)
    op_of = {k: v['op'][len('mv2d::'):] for k, v in KERNELS.items()}

    def cost(counts):
        return sum(c * (per_call[op_of[k]]['op_us']
                        - per_call[op_of[k]]['direct_us'])
                   for k, c in counts.items()) / 1e3

    # a step's K3 launches: the no-grad detect pass and the R-CNN RoIs
    step = {**TRAIN_PER_STEP, 'roi_align_multilevel': 2}
    fwd_ms, step_ms = cost(EVAL_PER_FORWARD), cost(step)
    for name, r in per_call.items():
        extra = r['op_us'] - r['direct_us']
        log(f'  op mv2d::{name:<22} {r["op_us"]:7.1f} us a call, direct '
            f'{r["direct_us"]:7.1f} us: dispatch {extra:6.1f} us')
    log(f'  dispatch per eval forward ({sum(EVAL_PER_FORWARD.values())} '
        f'calls) {fwd_ms:.3f} ms, per training step '
        f'({sum(step.values())} calls) {step_ms:.3f} ms; '
        f'{results.get("_smi", "")}')
    results['_op_overhead'] = dict(per_call=per_call, forward_ms=fwd_ms,
                                   step_ms=step_ms)
    return all(np.isfinite(r['op_us']) for r in per_call.values())


def path_kernels(cfg, training=False, dn=False):
    """(the kernels that a forward of `cfg` on the default routes launches
    (training: a step's, with DN queries if `dn`), the masks its decoder
    packs a pass): K4 (with B8 in training) for every shared-key
    attention, K1 for a DCN-free ResNet layer1, K2 (B5 and B6 in a
    trained stage) for a ResNet with DCN, K3 (and B9) for the two-stage
    detector's R-CNN, the NMS kernel for both detectors; the
    self-attention mask, and the cross-attention
    mask where the keys are shared (the pixel key mode, or roi with
    DN)."""
    need = ['masked_attention', 'mask_bits']
    resnet = cfg.backbone_type == 'resnet'
    if resnet and not cfg.stage_with_dcn[0]:
        need.append('fused_stage1')
    # stages below max(frozen_stages, 1) run without gradients, so their
    # DCN convs take K2 in training too
    frozen = max(cfg.frozen_stages, 1)
    dcn = [s for s in range(4) if resnet and cfg.stage_with_dcn[s]]
    if any(s < frozen or not training for s in dcn):
        need.append('dcn_conv')
    if training and any(s >= frozen for s in dcn):
        need += ['dcn_samples', 'dcn_samples_backward']
    need.append('nms_keep')          # both detectors' NMS
    if cfg.detector_type == 'two_stage':
        need.append('roi_align_multilevel')
        if training:
            need.append('roi_align_multilevel_backward')
    if training:
        need.append('masked_attention_backward')
    shared_cross = cfg.key_mode == 'pixel' or dn
    return tuple(need), 1 + shared_cross


def _launch_check(launched, need, graph=None):
    """Every kernel in `need` launched, every other kernel not; where
    `graph` (`detect_graph_calls` over the same calls) has replays and no
    capture, `detect`'s kernels in `need` may go uncalled: the replays ran
    them."""
    quiet = set()
    if graph and graph['replays'] and not graph['captures']:
        quiet = set(DETECT_CALLS) | set(DETECT_CALLS_V2)
    return all((launched[n] > 0) == (n in need)
               or (n in need and n in quiet) for n in launched)


def phase_tiny_parity(dev, cfg=None, label='tiny+DCN', matched=False):
    """A tiny config's eval forward (default: with DCN, two frames),
    GPU (kernels, float32) vs CPU (plain): valid slots and labels equal,
    scores within 1e-4 and boxes within 1e-3 on valid slots; the GPU
    launching exactly `path_kernels(cfg)`.  With `matched`, each box is
    held against the other side's boxes of its label and score (two
    queries whose scores tie within float32 rounding may swap slots)."""
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights
    cfg = cfg or configs.tiny(stage_with_dcn=(False, False, True, True),
                              num_frames=2, k_max=48)
    V = cfg.total_views
    K, E = camera_rig(V, cfg.image_size)
    ts = [0.0] * cfg.num_views + [0.5] * (V - cfg.num_views)
    imgs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(V, *cfg.image_size, 3)).astype(np.float32))
    shapes = torch.tensor([list(cfg.image_size)] * V)
    model = init_random_weights(MV2D(cfg, Routes()).eval(), seed=3)
    fns = counters()
    outs = {}
    for d in ('cpu', dev):
        m = model.to(d)
        cam = prepare_camera_params(K, E, ts, device=d)
        for fn in fns.values():
            fn.launches = 0
        outs[d] = [t.cpu() if torch.is_tensor(t) else t
                   for t in m(imgs.to(d), cam, shapes.to(d))]
    launched = {n: fn.launches for n, fn in fns.items()}
    c, g = outs['cpu'], outs[dev]
    valid_same = torch.equal(c[3], g[3])
    v = c[3]
    n = int(v.sum())
    box_err = (c[0][v] - g[0][v]).abs().max().item() if n else 0.0
    if matched and n:
        box_err = 0.0
        for i in torch.nonzero(v)[:, 0]:
            peers = v & (c[2] == g[2][i]) & ((c[1] - g[1][i]).abs() < 1e-4)
            box_err = max(box_err, (c[0][peers] - g[0][i]).abs().amax(-1)
                          .min().item() if peers.any() else float('inf'))
    score_err = (c[1][v] - g[1][v]).abs().max().item() if n else 0.0
    labels_same = torch.equal(c[2][v], g[2][v])
    need, _ = path_kernels(cfg)
    launch_ok = _launch_check(launched, need)
    ok = valid_same and labels_same and box_err < 1e-3 and \
        score_err < 1e-4 and n > 0 and launch_ok
    log(f'  {label} GPU vs CPU: valid={n} same_valid={valid_same} '
        f'same_labels={labels_same} box_err={box_err:.3e} '
        f'score_err={score_err:.3e}; GPU launches '
        f'{ {k: x for k, x in launched.items() if x} } '
        f'(expected {sorted(need)}) {"ok" if ok else "FAIL"}')
    return ok


def to_device(obj, dev):
    """Tensors inside NamedTuples, dataclasses and sequences, moved."""
    import dataclasses
    import torch
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(to_device(x, dev) for x in obj))
    return obj


DEFAULT_TRAIN_NEED = ('dcn_samples', 'dcn_samples_backward',
                      'masked_attention', 'masked_attention_backward',
                      'roi_align_multilevel', 'roi_align_multilevel_backward',
                      'mask_bits', 'nms_keep')


def phase_tiny_train(dev, need=DEFAULT_TRAIN_NEED, absent=ROUTED_KERNELS,
                     routes=None, cfg=None, label='tiny+DCN'):
    """One training step of a tiny config (default: with DCN, two frames;
    float32, dropout 0) on the GPU (kernels) and on the CPU (plain
    versions), same weights and draws, the model built with `routes`
    (default: `Routes()`): every loss term within 1e-4 relative, every
    parameter's gradient within 1e-3 of its max magnitude (floored at
    1e-5 of the largest gradient), the discrete counts equal; the kernels
    in `need` launched on the GPU, those in `absent` not."""
    import copy
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.parallel.dist import dp_objective
    from mv2d_tpu_torch.train.train_step import draw_train
    cfg = cfg or configs.tiny(stage_with_dcn=(False, False, True, True),
                              num_frames=2, dropout=0.0,
                              use_flash_attention=True)
    batch = synthetic_train_batch(cfg, seed=0, device='cpu')
    draws = draw_train(cfg, batch.gt2d.boxes.shape[1],
                       torch.Generator().manual_seed(1))
    model = init_random_weights(MV2D(cfg, routes or Routes()), seed=3)
    fns = counters()
    runs = {}
    for d in ('cpu', dev):
        m = copy.deepcopy(model).to(d)
        for fn in fns.values():
            fn.launches = 0
        local, metrics = dp_objective(m, [to_device(batch, d)],
                                      [to_device(draws, d)],
                                      mixed_precision=False)
        local.backward()
        runs[d] = ({k: float(v) for k, v in metrics.items()},
                   {n: p.grad.detach().cpu() for n, p in
                    m.named_parameters() if p.grad is not None})
    launched = {n: fn.launches for n, fn in fns.items()}
    (mc, gc), (mg, gg) = runs['cpu'], runs[dev]
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
                   for k in mc if 'loss' in k)
    counts_same = all(mg[k] == mc[k] for k in mc if 'loss' not in k)
    floor = 1e-5 * max(g.abs().max().item() for g in gc.values())
    grad_err = max((gg[n] - gc[n]).abs().max().item()
                   / max(gc[n].abs().max().item(), floor) for n in gc)
    ok = (loss_err <= 1e-4 and grad_err <= 1e-3 and counts_same
          and set(gg) == set(gc) and all(launched[n] > 0 for n in need)
          and all(launched[n] == 0 for n in absent))
    log(f'  {label} train step GPU vs CPU: {len(gc)} gradients, '
        f'worst loss rel err {loss_err:.2e} (tol 1e-4), worst grad err '
        f'{grad_err:.2e} of max (tol 1e-3), counts_same={counts_same}, '
        f'GPU launches {launched} {"ok" if ok else "FAIL"}')
    return ok


def phase_variants_tiny(dev):
    """The model families besides MV2D-T at tiny size, float32 with TF32
    off, GPU (kernels) against CPU (plain versions) to phase_tiny_parity's
    and phase_tiny_train's tolerances and launch checks: the roi key mode
    (MV2D-S) forward and, with DN, a training step; the single-stage
    (RetinaNet) detector's forward and step; the VoVNet-19 backbone's
    forward."""
    from mv2d_tpu_torch import configs
    roi = configs.tiny(key_mode='roi')
    roi_dn = configs.tiny(key_mode='roi', use_denoise=True, dropout=0.0)
    single = configs.tiny(detector_type='single_stage')
    vov = configs.tiny(backbone_type='vovnet', depth=19)
    ok = phase_tiny_parity(dev, roi, 'tiny roi')
    need, _ = path_kernels(roi_dn, training=True, dn=True)
    ok &= phase_tiny_train(dev, need, tuple(set(KERNELS) - set(need)),
                           cfg=roi_dn, label='tiny roi+DN')
    ok &= phase_tiny_parity(dev, single, 'tiny single-stage')
    need, _ = path_kernels(single, training=True)
    ok &= phase_tiny_train(dev, need, tuple(set(KERNELS) - set(need)),
                           cfg=single._replace(dropout=0.0),
                           label='tiny single-stage')
    ok &= phase_tiny_parity(dev, vov, 'tiny VoVNet-19', matched=True)
    return ok


def _clone(a):
    import torch
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, tuple) and hasattr(a, '_fields'):
        return type(a)(*(_clone(x) for x in a))
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


class _Recorder:
    """Stands in for a module function: keeps the first call's (filtered)
    arguments in `seen`, calls the function, and passes its `launches`
    counter through (a wrapper counts its launches under its own module
    name, which the recorder then holds)."""

    def __init__(self, fn, seen, key, want):
        self.fn, self.seen, self.key, self.want = fn, seen, key, want

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args):
        if self.key not in self.seen and self.want(args):
            self.seen[self.key] = _clone(args)
        return self.fn(*args)


def _record_first(seen, patches):
    """Put a _Recorder in place of each (module, name); returns the
    originals to restore."""
    originals = {}
    for mod, name, key, want in patches:
        fn = getattr(mod, name)
        originals[(mod, name)] = fn
        setattr(mod, name, _Recorder(fn, seen, key, want))
    return originals


def _replay(seen, plain, kernels, label):
    """Each recorded call through kernel and plain version (bf16 tol)."""
    ok = True
    for name, args in seen.items():
        err, rel, fin, same = compare_all(as_list(kernels[name](*args)),
                                          as_list(plain[name](*args)))
        good = fin and same and rel <= BF16_TOL
        ok &= good
        log(f'  replay {label} {name:<30} max_abs_err={err:.3e} '
            f'rel={rel:.2e} {"ok" if good else "FAIL"}')
    missing = set(kernels) - set(seen)
    if missing:
        log(f'  kernels never reached: {sorted(missing)}')
        ok = False
    return ok


def phase_serve(dev, results, n_requests=3, cfg=None, label='serve'):
    """n_requests bf16 forwards of `cfg` (default MV2D-T R50) at full
    width on seeded weights: finite outputs of the expected shapes, the
    launches of exactly `path_kernels(cfg)` (the decoder's masks packed
    once a pass, K4 on its layers' shared-key attentions), ms a forward
    and peak memory, and each kernel's first inputs replayed through its
    plain version.  Launches go under `label` in launches_by_path."""
    import torch
    import mv2d_tpu_torch.models.detector2d as det2d
    import mv2d_tpu_torch.nn.decoder as decoder
    import mv2d_tpu_torch.nn.resnet as resnet
    import mv2d_tpu_torch.ops.dcn as dcn
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.ops import attention, roi_align, stage
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import camera_rig, init_random_weights

    cfg = cfg or configs.mv2d_t_r50()
    need, masks = path_kernels(cfg)
    V, (H, W) = cfg.total_views, cfg.image_size
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(
        K, E, [0.0] * cfg.num_views + [0.5] * (V - cfg.num_views),
        device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    model = init_random_weights(MV2D(cfg, Routes()).eval(), seed=0).to(
        dev, torch.bfloat16)

    # record the inputs each kernel wrapper sees first on the main path:
    # wrap the callers' references (a wrapper's own module stays as it is,
    # its launch counter lives there); attention records the first call
    # whose values are not all zero (layer 0's self-attention has zero
    # values: the pixel mode's first record is a cross-attention, the roi
    # mode's a later layer's self-attention); the DCN wrapper's caller is
    # in its own module, so the first DCN module's input is recorded by a
    # hook and the kernel's inputs derived from it
    seen = {}
    patches = [(decoder, 'masked_attention', 'masked_attention',
                lambda a: bool(a[2].abs().amax() > 0))]
    if 'fused_stage1' in need:
        patches.append((resnet, 'fused_stage1', 'fused_stage1',
                        lambda a: True))
    if 'roi_align_multilevel' in need:
        patches.append((det2d, 'roi_align_multilevel',
                        'roi_align_multilevel', lambda a: True))
    originals = _record_first(seen, patches)
    handle = None
    if 'dcn_conv' in need:
        first_dcn = next(m for m in model.modules()
                         if isinstance(m, dcn.ModulatedDeformConv))

        def dcn_hook(m, inputs):
            if 'dcn_conv' not in seen:
                x = inputs[0].detach().clone()
                sy, sx, mask = m.sample_coords(x)
                seen['dcn_conv'] = (x, sy.contiguous(), sx.contiguous(),
                                    mask, m.tap_weights(x.dtype))
        handle = first_dcn.register_forward_pre_hook(dcn_hook)

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    torch.cuda.reset_peak_memory_stats()
    ms, out = [], None
    try:
        for _ in range(n_requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(imgs, cam, shapes)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        if handle is not None:
            handle.remove()
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path'][label] = n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    graph = detect_graph_calls(graph0)
    # detect's kernel runs in one more forward, as the device records them
    # (a replay's too): the wrappers count no replay
    runs, _ = kernel_runs(lambda: model(imgs, cam, shapes))
    want_runs = {k: c if k in need else 0 for k, c in DETECT_CALLS.items()}
    results.setdefault('_detect_graph', {})[label] = dict(
        graph, kernel_runs_per_forward=runs)
    boxes, scores, labels, valid, diag = out
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (boxes, scores))
    shapes_ok = (tuple(boxes.shape) == (cfg.max_per_scene, 9)
                 and tuple(scores.shape) == (cfg.max_per_scene,))
    per_forward = {'mask_bits': masks,
                   'masked_attention': masks * cfg.num_decoder_layers}
    launch_ok = _launch_check(launches, need, graph) and all(
        launches[n] == k * n_requests for n, k in per_forward.items()) \
        and runs == want_runs
    ok = finite and shapes_ok and launch_ok
    log(f'  forward ms ({cfg.backbone_type}{cfg.depth}, {cfg.key_mode} '
        f'keys, bf16, {H}x{W} x {V} views): '
        + ', '.join(f'{t:.1f}' for t in ms) + f'; peak memory '
        f'{peak_gb:.2f} GiB')
    log(f'  valid detections={int(valid.sum())} '
        + ' '.join(f'{k}={int(v)}' for k, v in diag.items())
        + f' finite={finite} shapes_ok={shapes_ok}')
    log(f'  wrapper calls in {n_requests} forwards: {launches} (expected '
        f'{sorted(need)}, per forward {per_forward}); detect graph {graph}: '
        'its kernels run in a replay with no wrapper call, and the '
        'capturing call calls each wrapper twice; detect\'s kernel runs in '
        f'one more forward, by the device\'s records: {runs} (want '
        f'{want_runs}) {"ok" if launch_ok else "FAIL"}')
    if label == 'serve':
        results['_forward_ms'] = ms
        results['_serve_peak_gb'] = peak_gb
    else:
        results[f'_{label}_ms'] = ms
        results[f'_{label}_peak_gb'] = peak_gb

    def attn_plain(q, k, v, a, H, tiles=None):
        return attention.masked_attention_plain(q, k, v, a, H)

    plain = {'fused_stage1': stage.fused_stage1_plain,
             'dcn_conv': dcn.dcn_conv_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'masked_attention': attn_plain}
    plain = {n: f for n, f in plain.items() if n in need}
    return _replay(seen, plain, {n: fns[n] for n in plain}, label) and ok


def _scene(mc, seed=0):
    """A request's arrays for a config: N(0, 1) images, the camera rig,
    timestamps 0 / 0.5 for the two frames."""
    from mv2d_tpu_torch.synthetic import camera_rig
    V = mc.total_views
    K, E = camera_rig(V, mc.image_size)
    return dict(images=np.random.default_rng(seed).normal(
        size=(V, *mc.image_size, 3)).astype(np.float32),
        intrinsics=K, extrinsics=E,
        timestamps=np.asarray([0.0] * mc.num_views
                              + [0.5] * (V - mc.num_views)))


def _post(url, arrays):
    """POST /predict -> (status, response arrays or error, client ms)."""
    import io
    import urllib.error
    import urllib.request
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url + '/predict', data=buf.getvalue(),
                                 method='POST')
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            body = dict(np.load(io.BytesIO(r.read())))
            code = r.status
    except urllib.error.HTTPError as e:
        code, body = e.code, json.load(e)
    return code, body, (time.perf_counter() - t0) * 1e3


class _Server:
    """The port's HTTP server on 127.0.0.1 (a free port) in a thread."""

    def __init__(self, path, routes, max_batch, timeout_ms, dev,
                 options=None):
        import threading
        from http.server import ThreadingHTTPServer
        from mv2d_tpu_torch.tools.common import load_cli_config
        from mv2d_tpu_torch.tools.serve import (ModelRunner, make_handler,
                                                metadata)
        cfg = load_cli_config(path, options)
        self.runner = ModelRunner(cfg, None, max_batch, timeout_ms,
                                  device=dev, routes=routes)
        self.srv = ThreadingHTTPServer(
            ('127.0.0.1', 0), make_handler(self.runner,
                                           metadata(cfg, self.runner)))
        self.url = f'http://127.0.0.1:{self.srv.server_address[1]}'
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def get(self, route):
        import urllib.request
        with urllib.request.urlopen(self.url + route, timeout=60) as r:
            return json.load(r)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join()
        self.runner.close()


def _response_ok(out, mc):
    n = mc.max_per_scene
    v = out['valid'].astype(bool)
    return (out['boxes_3d'].shape == (n, 9) and out['scores_3d'].shape == (n,)
            and out['labels_3d'].shape == (n,) and out['valid'].shape == (n,)
            and bool(v.any()) and bool(np.isfinite(out['boxes_3d'][v]).all())
            and bool(np.isfinite(out['scores_3d'][v]).all()))


ROI_FILE = 'configs/mv2d/mv2d_r50_frcnn_single_frame_roi_1408x512_ep24.py'


def phase_http(dev, results, options=(), options_r101=(), options_roi=()):
    """The port's server, as a user reaches the eval forward: the R50
    config file with align_v2 (B11), max batch 2, batch timeout 200 ms;
    then roi_forward (B12) on one scene's proposals; then the R101 file;
    then the MV2D-S file (roi key mode), one request whose answer must
    equal a direct forward.  `options` (--cfg-options) shrink the configs
    for a rehearsal."""
    import threading
    import torch
    from mv2d_tpu_torch.ops import roi_align
    from mv2d_tpu_torch.routes import Routes

    fns = counters()
    srv = _Server('configs/mv2d/mv2d_r50_frcnn_two_frames_1408x512_ep24.py',
                  Routes(align_v2=True), 2, 200.0, dev, list(options))
    runner, mc = srv.runner, srv.runner.mc
    ok = srv.get('/health') == {'status': 'ok'}
    meta = srv.get('/metadata')
    ok &= meta['views'] == 12 and meta['image_size'] == list(mc.image_size)
    scenes = [_scene(mc, seed) for seed in range(4)]
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    answers = [_post(srv.url, scenes[0])] + [None] * 3

    def ask(i):
        answers[i] = _post(srv.url, scenes[i])
    threads = [threading.Thread(target=ask, args=(i,)) for i in (1, 2, 3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['http'] = n
    metrics = srv.get('/metrics')
    codes = [a[0] for a in answers]
    shapes_ok = codes == [200] * 4 and all(_response_ok(a[1], mc)
                                           for a in answers)
    graph = detect_graph_calls(graph0)
    want = expect_calls({'roi_align_slab': 1, 'nms_keep': NMS_PER_DETECT},
                        4, graph, DETECT_CALLS_V2)
    need = set(path_kernels(mc)[0]) - {'roi_align_multilevel'}
    launch_ok = (all(launches[n] == k for n, k in want.items())
                 and launches['mask_bits'] == MASKS_PER_PASS * 4
                 and launches['roi_align_multilevel'] == 0
                 and launches['roi_align_flat'] == 0
                 and _launch_check({n: launches[n] for n in need}, need,
                                   graph))
    metrics_ok = (metrics['requests'] == 4 and metrics['errors'] == 0
                  and metrics['batches'] < 4)
    log(f'  R50 align_v2: statuses {codes}; client ms '
        + ', '.join(f'{a[2]:.1f}' for a in answers)
        + f' (the first alone, then three at once); /metrics {metrics}')
    log(f'  wrapper calls for the 4 requests: {launches} (want {want}, '
        f'K3 0, where detect\'s graph {graph} replays) '
        f'{"ok" if launch_ok else "FAIL"}')
    results['_http'] = dict(client_ms=[a[2] for a in answers], **metrics)

    # each answer against a direct forward of the same model and arrays
    match_ok = True
    for (code, out, _), arrays in zip(answers, scenes):
        with torch.inference_mode():
            det = runner.model(*runner.inputs(arrays))
        same = code == 200 and np.array_equal(det.valid.cpu().numpy(),
                                              out['valid'])
        err = float('nan')
        if same:
            v = out['valid'].astype(bool)
            err = max(compare(torch.from_numpy(out[k][v]),
                              getattr(det, a).float().cpu()[v])[1]
                      for k, a in (('scores_3d', 'scores'),
                                   ('boxes_3d', 'boxes')))
        match_ok &= same and err <= BF16_TOL
        log(f'  answer vs direct forward: same valid {same}, worst score / '
            f'box error {err:.2e} of max (tol {BF16_TOL:.0e})')

    code, body, _ = _post(srv.url, dict(images=np.zeros((2, 8, 8, 3),
                                                        np.float32),
                                        intrinsics=np.eye(4)[None],
                                        extrinsics=np.eye(4)[None]))
    bad_ok = code == 400
    log(f'  bad request: status {code} {body} {"ok" if bad_ok else "FAIL"}')

    # roi_forward (B12) on the first scene's FPN levels and proposals
    model = runner.model
    det2d = model.base_detector
    strides = (4, 8, 16, 32)
    with torch.inference_mode():
        fpn = det2d.extract_feat(runner.inputs(scenes[0])[0])
        boxes, _, _ = det2d.rpn(fpn, mc.image_size, mc.proposal_test)
        V, P = boxes.shape[:2]
        rois = boxes.reshape(V * P, 4)
        views = torch.arange(V, device=dev).repeat_interleave(P)
        for fn in fns.values():
            fn.launches = 0
        cls, reg = det2d.roi_forward(fpn, rois, views)
        torch.cuda.synchronize()
        rf = {n: fn.launches for n, fn in fns.items()}
        for name, n in rf.items():
            results[name]['launches_by_path']['roi_forward'] = n
        feats = list(fpn[:4])
        f12 = roi_align.roi_align_flat(feats, rois, views, strides)
        f3 = roi_align.roi_align_multilevel(feats, boxes, strides)
        f11 = roi_align.roi_align_slab(feats, boxes, strides)
        torch.cuda.synchronize()
        e3 = compare(f12.reshape(f3.shape), f3)
        e11 = compare(f12.reshape(f3.shape), f11)
        head = det2d.roi_head.bbox_head(f3.reshape(V * P, *f3.shape[2:]))
        eh = compare_all([cls, reg], head)
    rf_ok = (rf['roi_align_flat'] == 1 and rf['roi_align_slab'] == 0
             and rf['roi_align_multilevel'] == 0 and e3[1] <= BF16_TOL
             and e11[1] <= BF16_TOL and e3[2] and e11[2]
             and eh[1] <= BF16_TOL)
    log(f'  roi_forward on {V * P} proposals: launches B12 '
        f'{rf["roi_align_flat"]}, B11 {rf["roi_align_slab"]}, K3 '
        f'{rf["roi_align_multilevel"]}; features vs K3 rel {e3[1]:.2e}, vs '
        f'B11 rel {e11[1]:.2e}; head vs head on K3 rel {eh[1]:.2e} (tol '
        f'{BF16_TOL:.0e}) {"ok" if rf_ok else "FAIL"}')
    srv.close()
    del srv, runner, model, det2d, fpn, feats, f12, f3, f11
    torch.cuda.empty_cache()

    # one request to the R101 1600x640 server (default routes)
    srv = _Server('configs/mv2d/mv2d_r101_frcnn_two_frames_1600x640_ep24.py',
                  Routes(), 1, 8.0, dev, list(options_r101))
    mc101 = srv.runner.mc
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    code, out, ms = _post(srv.url, _scene(mc101, 7))
    torch.cuda.synchronize()
    l101 = {n: fn.launches for n, fn in fns.items()}
    g101 = detect_graph_calls(graph0)
    for name, n in l101.items():
        results[name]['launches_by_path']['http_r101'] = n
    r101_ok = (code == 200 and _response_ok(out, mc101)
               and (mc101.depth, mc101.k_max) == (101, 24576)
               and _launch_check(l101, path_kernels(mc101)[0], g101)
               and l101['mask_bits'] == MASKS_PER_PASS)
    log(f'  R101 {mc101.image_size[1]}x{mc101.image_size[0]} k_max '
        f'{mc101.k_max}: status {code}, client ms '
        f'{ms:.1f}, valid {int(out["valid"].sum()) if code == 200 else 0}, '
        f'wrapper calls {l101} (detect graph {g101}) '
        f'{"ok" if r101_ok else "FAIL"}')
    results['_http_r101_ms'] = ms
    srv.close()
    del srv
    torch.cuda.empty_cache()

    # one request to a server of the MV2D-S file (roi key mode, one
    # frame), its answer against a direct forward of the same model
    srv = _Server(ROI_FILE, Routes(), 1, 8.0, dev, list(options_roi))
    mcs = srv.runner.mc
    scene = _scene(mcs, 9)
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    code, out, ms = _post(srv.url, scene)
    torch.cuda.synchronize()
    lroi = {n: fn.launches for n, fn in fns.items()}
    groi = detect_graph_calls(graph0)
    for name, n in lroi.items():
        results[name]['launches_by_path']['http_roi'] = n
    with torch.inference_mode():
        det = srv.runner.model(*srv.runner.inputs(scene))
    need, masks = path_kernels(mcs)
    roi_same = code == 200 and _response_ok(out, mcs) and all(
        np.array_equal(out[k], getattr(det, a).cpu().numpy())
        for k, a in (('valid', 'valid'), ('labels_3d', 'labels')))
    if roi_same:
        v = out['valid'].astype(bool)
        roi_same = max(compare(torch.from_numpy(out[k][v]),
                               getattr(det, a).float().cpu()[v])[1]
                       for k, a in (('scores_3d', 'scores'),
                                    ('boxes_3d', 'boxes'))) <= SELF_TOL
    roi_ok = (roi_same and mcs.key_mode == 'roi' and mcs.total_views == 6
              and _launch_check(lroi, need, groi)
              and lroi['mask_bits'] == masks)
    log(f'  MV2D-S {mcs.image_size[1]}x{mcs.image_size[0]} x '
        f'{mcs.total_views} views (roi keys): status {code}, client ms '
        f'{ms:.1f}, valid {int(out["valid"].sum()) if code == 200 else 0}, '
        f'equal to a direct forward {roi_same}, wrapper calls {lroi} '
        f'(detect graph {groi}) {"ok" if roi_ok else "FAIL"}')
    results['_http_roi_ms'] = ms
    srv.close()
    del srv, det
    torch.cuda.empty_cache()
    return (ok and shapes_ok and launch_ok and metrics_ok and match_ok
            and bad_ok and rf_ok and r101_ok and roi_ok)


R50_FILE = 'configs/mv2d/mv2d_r50_frcnn_two_frames_1408x512_ep24.py'
# launches per eval forward on the default routes (K1: layer1's three
# bottlenecks; K2: the nine DCN convs; K3: the R-CNN RoIs; K4: the decoder's
# six layers x self- and cross-attention; the RPN's and the R-CNN's NMS).
# Where `detect` replays its CUDA graph, the replay adds the launches the
# graph holds to each wrapper's count (the capture adds none), so a
# forward counts the same launches graphed or eager.
EVAL_PER_FORWARD = {'fused_stage1': 3, 'dcn_conv': 9,
                    'roi_align_multilevel': 1, 'masked_attention': 12,
                    'mask_bits': MASKS_PER_PASS, 'nms_keep': NMS_PER_DETECT}
SUBMISSION_KEYS = {'sample_token', 'translation', 'size', 'rotation',
                   'velocity', 'detection_name', 'detection_score',
                   'attribute_name'}


def _records_close(got, want):
    """Two scenes' submission records: the same count and classes, the
    worst score and box error (translation, size, rotation, velocity)
    relative to the largest magnitude -> (same, error)."""
    if len(got) != len(want) or not got or [r['detection_name'] for r in got] \
            != [r['detection_name'] for r in want]:
        return False, float('nan')

    def arrays(recs):
        return (np.asarray([r['detection_score'] for r in recs]),
                np.asarray([r['translation'] + r['size'] + r['rotation']
                            + r['velocity'] for r in recs]))
    errs = [np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)
            for a, b in zip(arrays(got), arrays(want))]
    return True, float(max(errs))


def phase_eval(dev, results, n_scenes=8, options=(), image_hw=(900, 1600),
               e2e_samples=16):
    """The eval path from disk to metrics: render `n_scenes` val scenes of
    the synthetic fixture (1600x900 JPEGs, 14 objects a scene), save the
    serve phase's seeded weights as a .pth, run the port's tools/test.py
    `main` on the R50 file with data.val pointed at the fixture, then
    `eval_e2e_bench.run` on the same fixture, 3 repeats.  `options`
    (--cfg-options) shrink the config for a rehearsal."""
    import os
    import tempfile
    import torch
    from mv2d_tpu_torch.data import pipeline
    from mv2d_tpu_torch.data.nuscenes import to_eval_inputs
    from mv2d_tpu_torch.eval import results as res
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import init_random_weights
    from mv2d_tpu_torch.tools import eval_e2e_bench
    from mv2d_tpu_torch.tools import test as test_cli
    from mv2d_tpu_torch.tools.common import (build_dataset, build_model,
                                             load_cli_config)
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture

    smi = results.get('_smi', '')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_eval_')
    try:
        t0 = time.perf_counter()
        paths = make_fixture(tmp, scenes=0, val_scenes=n_scenes,
                             objects=14, image_h=image_hw[0],
                             image_w=image_hw[1])
        opts = [f"data.val.info_path={paths['val_info']!r}",
                f"data.val.ann2d_path={paths['val_coco']!r}", *options]
        cfg = load_cli_config(R50_FILE, opts)
        model = init_random_weights(build_model(cfg, Routes()), seed=0)
        pth = os.path.join(tmp, 'weights.pth')
        torch.save(model.state_dict(), pth)
        out = os.path.join(tmp, 'submission.json')
        log(f'  fixture: {n_scenes} scenes x 6 cameras at {image_hw[1]}x'
            f'{image_hw[0]} rendered in {time.perf_counter() - t0:.1f} s')

        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        pool0 = pipeline.native_preprocess.calls
        graph0 = detect_graph_calls()
        t1 = time.perf_counter()
        metrics = test_cli.main([R50_FILE, pth, '--out', out, '--device',
                                 dev, '--cfg-options', *opts])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in fns.items()}
        pool_calls = pipeline.native_preprocess.calls - pool0
        for name, n in launches.items():
            results[name]['launches_by_path']['eval'] = n
        graph = detect_graph_calls(graph0)
        results.setdefault('_detect_graph', {})['eval'] = graph
        want = expect_calls({n: EVAL_PER_FORWARD.get(n, 0) for n in fns},
                            n_scenes, graph)
        launch_ok = launches == want
        log(f'  tools.test: {cli_s:.1f} s for {n_scenes} scenes; wrapper '
            f'calls {launches} (want {want}, detect graph {graph}) '
            f'{"ok" if launch_ok else "FAIL"}; C++ pool calls {pool_calls} '
            f'(want {n_scenes})')

        with open(out) as f:
            sub = json.load(f)
        dataset = build_dataset(cfg, 'val')
        tokens = [dataset.get_info(i)['token'] for i in range(n_scenes)]
        recs = sub.get('results', {})
        sub_ok = (set(sub) == {'meta', 'results'} and set(recs) == set(tokens)
                  and all(set(r) == SUBMISSION_KEYS
                          for rs in recs.values() for r in rs))
        classes = [k for k in metrics if k.endswith('_AP')]
        metrics_ok = (len(classes) == 10 and all(
            np.isfinite(metrics[k]) for k in ['mAP', 'NDS', *classes]))
        log(f'  submission: {len(recs)} scenes, '
            f'{sum(map(len, recs.values()))} boxes, devkit keys '
            f'{"ok" if sub_ok else "FAIL"}; mAP {metrics.get("mAP")} NDS '
            f'{metrics.get("NDS")}, {len(classes)} class APs finite '
            f'{"ok" if metrics_ok else "FAIL"}')

        # one scene of the run against a direct forward on its inputs: the
        # same weights, inputs and code, so only the records' float32
        # rounding may differ
        dtype = torch.bfloat16 if dev == 'cuda' else torch.float32
        model = model.eval().to(dev, dtype)
        s0 = dataset.get_sample(0)
        with torch.inference_mode():
            det = model(*to_eval_inputs(s0, dev, dtype))
        info = dataset.get_info(0)
        direct = res.to_nuscenes_submission(
            [info['token']], [res.boxes_to_pred_dict(
                *res.detections_numpy(det), info=info)],
            {info['token']: info})['results'][info['token']]
        same, err = _records_close(recs.get(info['token'], []), direct)
        match_ok = same and err <= SELF_TOL
        log(f'  scene 0 of the run vs a direct forward: same boxes and '
            f'classes {same}, worst score / box error {err:.2e} of max '
            f'(tol {SELF_TOL:.0e}) {"ok" if match_ok else "FAIL"}')

        # the pool against its plain numpy version on that scene
        dataset.native = False
        plain = dataset.get_sample(0)['imgs']
        dataset.native = True
        pool_err = float(np.abs(s0['imgs'] - plain).mean())
        pool_ok = pool_calls == n_scenes and pool_err < 0.05
        log(f'  C++ pool vs numpy on scene 0: mean abs {pool_err:.3e} (tol '
            f'0.05) {"ok" if pool_ok else "FAIL"}')

        bench = eval_e2e_bench.run(model, dataset, dev, samples=e2e_samples,
                                   repeat=3)
        log(f'  e2e eval: {bench["samples_per_s"]:.3f} samples/s (best of '
            f'3, {e2e_samples} scenes a repeat); ms/scene '
            + ', '.join(f'{k} {v:.2f}' for k, v in bench['ms'].items())
            + '; one sample alone: '
            + ', '.join(f'{k} {v:.2f} ms' for k, v in bench['alone'].items())
            + f'; {smi}')
        results['_eval'] = dict(cli_s=cli_s, **bench)
        # the tools phase evaluates the same scenes again
        KEEP['eval'] = dict(opts=opts, pth=pth, out=out, metrics=metrics)
        del model
    finally:
        KEEP.setdefault('dirs', []).append(tmp)
        torch.cuda.empty_cache()
    return launch_ok and sub_ok and metrics_ok and match_ok and pool_ok


# the golden's bf16 rows: each within BF16_TOL of its stage's largest
# reference value; the float32 control ('highest') of pe and roi_align
# within CONTROL_TOL absolute
CONTROL_TOL = 1e-4


def phase_parity(dev, results, n_prop=8, n_scenes=2, options=()):
    """The acceptance harness (`mv2d_tpu_torch.tools.parity`) in its
    --synthetic mode on MV2D-T R50 at full width: the stand-in's load
    report (every key taken), the golden of one 6-view frame with
    `n_prop` proposals a view (bf16 port against the float32 reference
    transcription on the host), the same with pe and roi_align re-run in
    float32 under matmul precision 'highest', then `run_val_eval` on
    `n_scenes` of the eval phase's rendered scenes.  Launches go under
    'parity': two golden forwards and the scenes', K1-K4 and mask_bits.
    `options` (--cfg-options) shrink the config for a rehearsal."""
    import torch
    from mv2d_tpu_torch.tools import parity
    from mv2d_tpu_torch.tools.common import (build_dataset,
                                             build_model_config,
                                             load_cli_config)

    smi = results.get('_smi', '')
    mc = build_model_config(load_cli_config(R50_FILE, options))
    sd = parity.synthetic_state_dict(mc)
    model, unmatched = parity.load_report(mc, sd)
    n_head = sum(k.startswith('roi_head.') for k in model.state_dict())
    load_ok = not unmatched and len(sd) == n_head
    log(f'  load report: {len(sd) - len(unmatched)}/{len(sd)} stand-in keys '
        f'taken, the port\'s head has {n_head} {"ok" if load_ok else "FAIL"}')

    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    sample = parity.rig_sample(mc)
    t0 = time.perf_counter()
    g = parity.run_golden(mc, model.state_dict(), sd, sample, n_prop, dev)
    t1 = time.perf_counter()
    ctl = parity.run_golden(mc, model.state_dict(), sd, sample, n_prop, dev,
                            'highest')
    t2 = time.perf_counter()
    if g is None or ctl is None:
        log('  golden compared nothing FAIL')
        return False
    parity.print_golden(g, mc, dev)
    log('  control, pe and roi_align in float32 under matmul precision '
        "'highest':")
    parity.print_golden(ctl, mc, dev)
    rows_ok = all(np.isfinite(e) and e <= BF16_TOL * g.scale[k]
                  for k, e in g.rows.items()) and len(g.rows) == 5
    ctl_ok = all(ctl.rows[k] < CONTROL_TOL for k in ('pe', 'roi_align'))
    golden_ok = (rows_ok and ctl_ok and g.proposals > 0
                 and g.key_overflow == 0)
    log(f'  golden: {g.proposals} proposals, key_overflow {g.key_overflow}; '
        f'rows within {BF16_TOL:.0e} of each stage\'s max |ref| {rows_ok}; '
        f'control pe / roi_align under {CONTROL_TOL:.0e} {ctl_ok}; '
        f'{t1 - t0:.1f} s + {t2 - t1:.1f} s (the reference on the host) '
        f'{"ok" if golden_ok else "FAIL"}; {smi}')
    results['_parity'] = dict(rows=g.rows, scale=g.scale,
                              control=ctl.rows, proposals=g.proposals,
                              key_active=g.key_active,
                              key_overflow=g.key_overflow)

    dataset = build_dataset(load_cli_config(R50_FILE, KEEP['eval']['opts']),
                            'val')
    metrics = parity.run_val_eval(model, dataset, n_scenes, True, dev)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['parity'] = n
    graph = detect_graph_calls(graph0)
    want = expect_calls({n: EVAL_PER_FORWARD.get(n, 0) for n in fns},
                        2 + n_scenes, graph)
    launch_ok = _launch_check(launches, path_kernels(mc)[0], graph) and \
        launches == want
    eval_ok = all(np.isfinite(metrics[k]) for k in ('mAP', 'NDS'))
    log(f'  eval on {n_scenes} of the eval phase\'s scenes: mAP '
        f'{metrics["mAP"]} NDS {metrics["NDS"]} '
        f'{"ok" if eval_ok else "FAIL"}; wrapper calls {launches} (want '
        f'{want}, detect graph {graph}) {"ok" if launch_ok else "FAIL"}')
    del model
    torch.cuda.empty_cache()
    return load_ok and golden_ok and eval_ok and launch_ok


# the stage benches' forward rows: their sum within this share of the full
# forward's row (host clock) either way
STAGE_SUM_SHARE = (0.67, 1.5)
# rows of `stage_bench --check` past BF16_TOL of their reference's max in
# bfloat16, each held instead to its bound here, just above its reading on
# the H100 at weight seed 0 (C4 4.89%, C5 6.05%, velocity 3.27%); every
# other row is held to BF16_TOL.  They are bf16 rounding that the JAX
# package shares, not faults of the port (ROADMAP.md queue C): its bf16
# backbone errs as much at C4 / C5 (tests/test_torch_port_bf16.py), and
# the velocity row reads 1.2-1.4% at weight seeds 1-3, K4's path within
# 0.999-1.027 times its plain version's error
FAULT_BOUNDS = {'backbone C4': 6e-2, 'backbone C5': 7e-2,
                'head velocity': 4e-2}
# the check's witness: the backbone's DCN layers and the head with K2 / K4
# and with their plain versions in the kernels' place, both in bf16 on the
# card: a kernel's path within this factor of its plain version's error
WITNESS_RATIO = 1.25


def _rows_ok(rows, dev):
    """Every row's host ms finite and positive; on the card its busy ms
    too, and its syncs counted."""
    return len(rows) > 0 and all(
        np.isfinite(r.host_ms) and r.host_ms > 0 and (
            dev != 'cuda' or (r.busy_ms is not None and np.isfinite(
                r.busy_ms) and r.busy_ms > 0 and r.sites is not None))
        for r in rows.values())


def phase_stages(dev, results, args=(), iters=2, warmup=1,
                 check_views='0,6'):
    """The stage benches (`mv2d_tpu_torch.tools.{stage_bench,
    detect_stage_bench, roi_stage_bench, train_stage_bench, train_bench,
    micro_bench, misc_bench}`) at MV2D-T R50's full width, each `main`
    with `iters` timed calls after `warmup`: every row's host ms, busy ms
    and top sync sites printed, each finite and positive, the forward's
    stage rows summing to within STAGE_SUM_SHARE of its full row; then
    `stage_bench --check` on `check_views` (the per-view stages on one
    view a frame, to keep the host's float32 run short), the full-width
    numeric check: every row within BF16_TOL of its reference's max, or
    within its FAULT_BOUNDS where queue C records it; every row's float32
    control within F32_TOL; and its witness, each kernel's bf16 path
    within WITNESS_RATIO of the error of its plain version's.  Launches
    go under 'stages': the eval and training paths' kernels launched.
    `args` (e.g. --preset tiny --device cpu) and `check_views` shrink the
    runs for a rehearsal."""
    import torch
    from mv2d_tpu_torch.tools import (detect_stage_bench, micro_bench,
                                      misc_bench, roi_stage_bench,
                                      stage_bench, stage_common,
                                      train_bench, train_stage_bench)

    smi = results.get('_smi', '')
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    graph0 = detect_graph_calls()
    it = ['--iters', str(iters), '--warmup', str(warmup), *args]
    ok = True
    for mod in (stage_bench, detect_stage_bench, roi_stage_bench,
                train_stage_bench, micro_bench, misc_bench):
        name = mod.__name__.rsplit('.', 1)[-1]
        t0 = time.perf_counter()
        # the JAX tool's default recomputes the backbone in the backward;
        # the phase times the step that trains, which keeps it
        extra = ['--no-remat'] if mod is train_stage_bench else []
        try:
            rows = mod.main(it + extra)['rows']
        except Exception as e:            # report, go on with the others
            import traceback
            traceback.print_exc()
            log(f'  {name} raised {type(e).__name__}: {e} FAIL')
            ok = False
            continue
        good = _rows_ok(rows, dev)
        if mod is stage_bench:
            share = sum(r.host_ms for k, r in rows.items() if k != 'full') \
                / rows['full'].host_ms
            lo, hi = STAGE_SUM_SHARE
            good &= lo <= share <= hi
            results['_stages_share'] = share
        results.setdefault('_stages', {})[name] = {
            k: dict(host_ms=r.host_ms, busy_ms=r.busy_ms, rounds=r.rounds,
                    syncs=r.syncs,
                    blocked_ms=r.blocked_ms,
                    top=[stage_common.site_name(st, x) for st, x in r.top()])
            for k, r in rows.items()}
        log(f'  {name}: {len(rows)} rows ({time.perf_counter() - t0:.1f} s) '
            f'{"ok" if good else "FAIL"}')
        ok &= good
    t0 = time.perf_counter()
    tb = train_bench.main(it)
    tb_ok = np.isfinite(tb['ms_per_step']) and np.isfinite(tb['loss'])
    log(f'  train_bench ({time.perf_counter() - t0:.1f} s) '
        f'{"ok" if tb_ok else "FAIL"}; {smi}')
    ok &= tb_ok
    t0 = time.perf_counter()
    check = stage_bench.main(['--check', '--check-views', check_views,
                              *args])['check']
    rows = {k: v for k, v in check.items() if not k.startswith('_')}
    faults = sorted(k for k, v in rows.items() if not v['ok'])
    over = sorted(k for k, v in rows.items() if not (
        np.isfinite(v['err']) and v['err'] <= FAULT_BOUNDS.get(
            k, BF16_TOL) * v['scale']))
    control_ok = all(v['f32'] <= F32_TOL * v['scale'] for v in rows.values())
    witness = check['_witness']
    wit_bad = sorted(k for k, v in witness.items() if v['plain'] is not None
                     and not v['kernel'] <= WITNESS_RATIO * v['plain'])
    check_ok = not over and control_ok and not wit_bad
    log(f'  stage_bench --check ({time.perf_counter() - t0:.1f} s): rows '
        f'over {BF16_TOL:.0e} {faults}, over their bounds {over} (bounds '
        f'{FAULT_BOUNDS}); float32 controls within {F32_TOL:.0e} '
        f'{control_ok}; witness (kernel / plain share) ' + ', '.join(
            f'{k} {v["kernel"]:.2e}/{v["plain"]:.2e}'
            for k, v in witness.items() if v['plain'] is not None)
        + f', past {WITNESS_RATIO}x: {wit_bad} '
        f'{"ok" if check_ok else "FAIL"}')
    results['_stages_check'] = rows
    results['_stages_witness'] = witness
    ok &= check_ok
    if dev == 'cuda':
        torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['stages'] = n
    from mv2d_tpu_torch import configs
    mc = configs.mv2d_t_r50()
    need = set(path_kernels(mc)[0]) | set(path_kernels(mc, True, True)[0])
    graph = detect_graph_calls(graph0)
    launch_ok = _launch_check({n: launches[n] for n in need}, need, graph)
    log(f'  wrapper calls {launches} (need {sorted(need)}; detect graph '
        f'{graph}) {"ok" if launch_ok else "FAIL"}')
    torch.cuda.empty_cache()
    return bool(ok and launch_ok)


def _attn_fwd_plain(q, k, v, a, H, tiles=None):
    """K4's training outputs (out, lse) by the plain versions."""
    from mv2d_tpu_torch.ops import attention
    return (attention.masked_attention_plain(q, k, v, a, H),
            attention.attention_lse_plain(q, k, a, H))


def _attn_bwd_plain(q, k, v, a, out, lse, dout, H, tiles=None):
    """B8's outputs by autograd of the plain attention."""
    from mv2d_tpu_torch.ops import attention
    if a is None:         # the autograd Function keeps MaskTiles only
        a = attention.mask_from_bits(tiles.bits, k.shape[0])
    return plain_grads(attention.masked_attention_plain, (q, k, v, a, H),
                       range(3), dout)[1]


def _roi_bwd_plain(feats, rois, dout, strides):
    """B9's outputs by autograd of the plain RoIAlign."""
    from mv2d_tpu_torch.ops import roi_align

    def fwd(*fs):
        return roi_align.multilevel_roi_align_plain(fs, rois, strides)
    return plain_grads(fwd, feats, range(len(feats)), dout)[1]


def phase_train(dev, results, n_steps=4, cfg=None):
    """Full-width training steps (bf16 mixed precision) on the synthetic
    scene; the first step is warm-up."""
    import torch
    import mv2d_tpu_torch.ops.attention as attention
    import mv2d_tpu_torch.ops.dcn as dcn
    import mv2d_tpu_torch.ops.roi_align as roi_align
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.parallel.dist import dp_train_step
    from mv2d_tpu_torch.train.optim import make_optimizer

    cfg = cfg or configs.mv2d_t_r50()
    model = init_random_weights(MV2D(cfg, Routes()), seed=0).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def cross(args):
        return args[1].shape[0] != args[0].shape[0]
    fns = counters()          # the wrappers themselves, before recording
    seen = {}
    originals = _record_first(seen, [
        (dcn, 'dcn_samples_forward', 'dcn_samples', lambda a: True),
        (dcn, 'dcn_samples_backward', 'dcn_samples_backward',
         lambda a: True),
        (attention, 'masked_attention_forward', 'masked_attention', cross),
        (attention, 'masked_attention_backward',
         'masked_attention_backward', cross),
        (roi_align, 'roi_align_multilevel', 'roi_align_multilevel',
         lambda a: True),
        (roi_align, 'roi_align_multilevel_backward',
         'roi_align_multilevel_backward', lambda a: True)])
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ms, steps = [], []
    graph0 = detect_graph_calls()
    try:
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = dp_train_step(model, opt, [batch], [gen])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            steps.append({k: float(v) for k, v in metrics.items()})
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    graph = detect_graph_calls(graph0)
    launches = {n: fn.launches for n, fn in fns.items()}
    for name, n in launches.items():
        results[name]['launches_by_path']['train'] = n
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = all(np.isfinite(v) for s in steps for v in s.values())
    frozen_still, moved, trainable = True, 0, 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if p.requires_grad:
            trainable += 1
            moved += not same
        else:
            frozen_still &= same
    want = expect_calls({**TRAIN_PER_STEP, 'roi_align_multilevel': 2},
                        n_steps, graph)
    k3_min = want.pop('roi_align_multilevel')
    per_step_ok = all(launches[n] == k for n, k in want.items()) and \
        launches['roi_align_multilevel'] >= k3_min
    # detect's kernel runs in one more step, as the device records them: the
    # no-grad detect's and the sampled proposals' NMS, K3 at least twice
    runs, _ = kernel_runs(lambda: dp_train_step(model, opt, [batch], [gen]))
    runs_ok = runs['nms_keep'] == NMS_PER_DETECT + 1 and \
        runs['roi_align_multilevel'] >= 2
    results.setdefault('_detect_graph', {})['train'] = dict(
        graph, kernel_runs_per_step=runs)
    ok = finite and frozen_still and moved >= 0.9 * trainable and \
        per_step_ok and runs_ok
    log(f'  train ms/step (bf16 mixed precision, {cfg.total_views} views '
        f'{cfg.image_size[0]}x{cfg.image_size[1]}; first is warm-up): '
        + ', '.join(f'{t:.1f}' for t in ms))
    log(f'  peak memory {peak_gb:.2f} GiB; finite={finite} '
        f'frozen_unchanged={frozen_still} trained_moved={moved}/{trainable}')
    for i, s in enumerate(steps):
        log(f'  step {i}: total_loss={s["total_loss"]:.4f} '
            f'grad_norm={s["grad_norm"]:.4f} lr={s["lr"]:.3e} '
            f'rpn_num_pos={s["rpn_num_pos"]:.0f} '
            f'rcnn_num_pos={s["rcnn_num_pos"]:.0f} '
            f'num_queries={s["num_queries"]:.0f} '
            f'key_active={s["key_active"]:.0f} '
            f'key_overflow={s["key_overflow"]:.0f}')
    log('  step 0 losses: ' + ', '.join(
        f'{k}={v:.4f}' for k, v in steps[0].items() if 'loss' in k))
    log(f'  wrapper calls in {n_steps} steps: {launches} (want {want}, '
        f'K3 >= {k3_min}: per step {TRAIN_PER_STEP}, K3 >= 2, where '
        f'detect\'s graph {graph} replays) '
        f'{"ok" if per_step_ok else "FAIL"}; detect\'s kernel runs in one '
        f'more step, by the device\'s records: {runs} (want nms_keep '
        f'{NMS_PER_DETECT + 1}, K3 >= 2) {"ok" if runs_ok else "FAIL"}')
    results['_train_ms'] = ms
    results['_train_peak_gb'] = peak_gb

    def dcn_bwd_plain(x, sy, sx, m, ds):
        return plain_grads(dcn.dcn_samples_plain, (x, sy, sx, m), range(4),
                           ds)[1]

    plain = {'dcn_samples': dcn.dcn_samples_plain,
             'dcn_samples_backward': dcn_bwd_plain,
             'masked_attention': _attn_fwd_plain,
             'masked_attention_backward': _attn_bwd_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'roi_align_multilevel_backward': _roi_bwd_plain}
    kern = {'dcn_samples': dcn.dcn_samples_forward,
            'dcn_samples_backward': dcn.dcn_samples_backward,
            'masked_attention': attention.masked_attention_forward,
            'masked_attention_backward': attention.masked_attention_backward,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'roi_align_multilevel_backward':
                roi_align.roi_align_multilevel_backward}
    return _replay(seen, plain, kern, 'train') and ok


def phase_train_s(dev, results, n_steps=4, n_dn_steps=2, cfg=None):
    """Full-width MV2D-S (roi key mode) training steps, bf16 mixed
    precision, synthetic_train_batch(seed=0), seeded weights: n_steps as
    configured (no DN: each query's own keys [834, 343, 256], per-query
    attention in batched matmuls, K4 and B8 on the self-attention; the
    first step is warm-up), then n_dn_steps with use_denoise=True (one
    shared key set of 834 x 49 = 40866 cells, 960 DN queries; K4 and B8
    on the cross-attention too).  Checks: finite losses, the DN loss terms
    in the second leg only, trained parameters moved and frozen ones not,
    each leg's launches (exactly `path_kernels`, K4 / B8 once a decoder
    layer for each shared-key mask, the masks packed once a step), ms a
    step and peak memory; each kernel's first inputs (the DN cross-
    attention's for K4 / B8) replayed through its plain version."""
    import torch
    import mv2d_tpu_torch.ops.attention as attention
    import mv2d_tpu_torch.ops.roi_align as roi_align
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.parallel.dist import dp_train_step
    from mv2d_tpu_torch.train.optim import make_optimizer

    cfg = cfg or configs.mv2d_s_r50()
    model = init_random_weights(MV2D(cfg, Routes()), seed=0).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def cross(args):
        return args[1].shape[0] != args[0].shape[0]
    fns = counters()
    seen = {}
    originals = _record_first(seen, [
        (attention, 'masked_attention_forward', 'masked_attention', cross),
        (attention, 'masked_attention_backward',
         'masked_attention_backward', cross),
        (roi_align, 'roi_align_multilevel', 'roi_align_multilevel',
         lambda a: True),
        (roi_align, 'roi_align_multilevel_backward',
         'roi_align_multilevel_backward', lambda a: True)])
    ok = True
    try:
        for label, n, dn in (('train_s', n_steps, False),
                             ('train_s_dn', n_dn_steps, True)):
            # the model reads use_denoise at each forward
            model.cfg = cfg._replace(use_denoise=dn)
            need, masks = path_kernels(model.cfg, training=True, dn=dn)
            for fn in fns.values():
                fn.launches = 0
            graph0 = detect_graph_calls()
            torch.cuda.reset_peak_memory_stats()
            ms, steps = [], []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = dp_train_step(model, opt, [batch], [gen])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                steps.append({k: float(v) for k, v in metrics.items()})
            launches = {k: fn.launches for k, fn in fns.items()}
            for name, k in launches.items():
                results[name]['launches_by_path'][label] = k
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            per_step = {'fused_stage1': 3, 'mask_bits': masks,
                        'masked_attention': masks * cfg.num_decoder_layers,
                        'masked_attention_backward':
                            masks * cfg.num_decoder_layers,
                        'roi_align_multilevel_backward': 1}
            graph = detect_graph_calls(graph0)
            want = expect_calls({**per_step, 'nms_keep': NMS_PER_DETECT + 1,
                                 'roi_align_multilevel': 2}, n, graph)
            k3_min = want.pop('roi_align_multilevel')
            launch_ok = _launch_check(launches, need, graph) and all(
                launches[k] == c for k, c in want.items()) and \
                launches['roi_align_multilevel'] >= k3_min
            finite = all(np.isfinite(v) for st in steps for v in st.values())
            dn_keys = [k for k in steps[0] if '.dn_loss' in k]
            dn_ok = bool(dn_keys) == dn and 'key_active' not in steps[0]
            ok &= launch_ok and finite and dn_ok
            log(f'  {label}: train ms/step (bf16 mixed precision, '
                f'{cfg.total_views} views {cfg.image_size[0]}x'
                f'{cfg.image_size[1]}, roi keys, DN {dn}) '
                + ', '.join(f'{t:.1f}' for t in ms)
                + f'; peak memory {peak:.2f} GiB; finite={finite}; '
                f'{len(dn_keys)} DN loss terms {"ok" if dn_ok else "FAIL"}')
            for i, st in enumerate(steps):
                log(f'  step {i}: total_loss={st["total_loss"]:.4f} '
                    f'grad_norm={st["grad_norm"]:.4f} '
                    f'num_queries={st["num_queries"]:.0f} '
                    f'rcnn_num_pos={st["rcnn_num_pos"]:.0f}')
            log(f'  wrapper calls in {n} steps: {launches} (expected '
                f'{sorted(need)}; want {want}, K3 >= {k3_min}: per step '
                f'{per_step}, the NMS 3, K3 >= 2, where detect\'s graph '
                f'{graph} replays) {"ok" if launch_ok else "FAIL"}')
            results[f'_{label}_ms'] = ms
            results[f'_{label}_peak_gb'] = peak
    finally:
        model.cfg = cfg
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    frozen_still, moved, trainable = True, 0, 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if p.requires_grad:
            trainable += 1
            moved += not same
        else:
            frozen_still &= same
    ok &= frozen_still and moved >= 0.9 * trainable
    log(f'  frozen_unchanged={frozen_still} trained_moved={moved}/'
        f'{trainable}')
    del model, opt, batch
    torch.cuda.empty_cache()
    plain = {'masked_attention': _attn_fwd_plain,
             'masked_attention_backward': _attn_bwd_plain,
             'roi_align_multilevel': roi_align.multilevel_roi_align_plain,
             'roi_align_multilevel_backward': _roi_bwd_plain}
    kern = {'masked_attention': attention.masked_attention_forward,
            'masked_attention_backward': attention.masked_attention_backward,
            'roi_align_multilevel': roi_align.roi_align_multilevel,
            'roi_align_multilevel_backward':
                roi_align.roi_align_multilevel_backward}
    return _replay(seen, plain, kern, 'train_s') and ok


def phase_train_remat(dev, results, n_steps=2, cfg=None):
    """n_steps full-width training steps (bf16 mixed precision, dropout
    on) of `cfg` (default MV2D-T R50) with remat and remat_decoder
    against n_steps without, from the same seeded weights, scene and
    generator seed: every metric and every parameter's gradient of each
    step equal bit for bit (every kernel on the path has one owner an
    output tile; cuDNN is held to its deterministic algorithms for the
    phase), the remat leg launching each recomputed kernel's forward
    twice a step (B5 in the trained DCN stages, K4 in the decoder) and
    every other kernel as often; ms a step and the peak memory of each
    leg.  Launches go under 'train_remat' (the remat leg's)."""
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.parallel.dist import dp_train_step
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.train.optim import make_optimizer

    base = cfg or configs.mv2d_t_r50()
    batch = synthetic_train_batch(base, seed=0, device=dev)
    fns = counters()
    legs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            c = base._replace(remat=remat, remat_decoder=remat)
            model = init_random_weights(MV2D(c, Routes()), seed=0).to(dev)
            opt = make_optimizer(model)
            gen = torch.Generator(device=dev).manual_seed(0)
            torch.cuda.synchronize()
            start_gb = torch.cuda.memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            for fn in fns.values():
                fn.launches = 0
            steps, ms = [], []
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = dp_train_step(model, opt, [batch], [gen])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                steps.append(({k: float(v) for k, v in metrics.items()},
                              {n: p.grad.detach().clone()
                               for n, p in model.named_parameters()
                               if p.grad is not None}))
            legs[remat] = dict(
                steps=steps, ms=ms, start_gb=start_gb,
                peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches={n: fn.launches for n, fn in fns.items()})
            del model, opt
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain, rem = legs[False], legs[True]
    for name, n in rem['launches'].items():
        results[name]['launches_by_path']['train_remat'] = n
    same_metrics = all(a[0] == b[0] for a, b in
                       zip(plain['steps'], rem['steps']))
    unequal = sorted({n for a, b in zip(plain['steps'], rem['steps'])
                      for n in set(a[1]) | set(b[1])
                      if n not in a[1] or n not in b[1]
                      or not torch.equal(a[1][n], b[1][n])})
    worst = max((float((a[1][n].float() - b[1][n].float()).abs().max())
                 for a, b in zip(plain['steps'], rem['steps'])
                 for n in a[1] if n in b[1]), default=0.0)
    twice = ('dcn_samples', 'masked_attention')
    la, lb = plain['launches'], rem['launches']
    launch_ok = all(lb[n] == 2 * la[n] > 0 for n in twice) and all(
        lb[n] == la[n] for n in la if n not in twice)
    finite = all(np.isfinite(v) for st in rem['steps']
                 for v in st[0].values())
    ok = same_metrics and not unequal and launch_ok and finite
    for remat, leg in legs.items():
        log(f'  remat={remat}: ms/step ' + ', '.join(
            f'{t:.1f}' for t in leg['ms']) + f'; memory at the start '
            f'{leg["start_gb"]:.2f} GiB, peak {leg["peak_gb"]:.2f} GiB; '
            f'total_loss ' + ', '.join(
                f'{st[0]["total_loss"]:.6f}' for st in leg['steps']))
    log(f'  metrics equal {same_metrics}; gradients unequal in '
        f'{len(unequal)} tensors {unequal[:5]} (worst abs diff '
        f'{worst:.3e}); launches without {la} with {lb} (forward '
        f'kernels {twice} twice) {"ok" if ok else "FAIL"}')
    results['_train_remat'] = {str(k): dict(ms=v['ms'],
                                            peak_gb=v['peak_gb'])
                               for k, v in legs.items()}
    return ok


def all_matched(cfg):
    """cfg with its correlation in the reference's 'all_matched' mode."""
    return cfg._replace(correlation=cfg.correlation._replace(
        mode='all_matched'))


def phase_serve_s_all(dev, results, n_requests=2, share=0.9):
    """n_requests full-width bf16 MV2D-S R50 forwards under 'all_matched'
    (each query's keys: the cells of all 1 + R RoIs), through
    `phase_serve`, if `serve_peak_estimate_gb` stays within `share` of
    the card's memory; otherwise the reckoning is printed and the
    forwards skipped."""
    import torch
    from mv2d_tpu_torch import configs
    cfg = all_matched(configs.mv2d_s_r50())
    est = serve_peak_estimate_gb(cfg)
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    fits = est <= share * card
    log(f'  reckoned peak {est:.1f} GiB of the card\'s {card:.1f} GiB '
        f'({"runs" if fits else "skipped: over"} {share:.0%})')
    if not fits:
        return True
    try:
        return phase_serve(dev, results, n_requests, cfg, 'serve_s_all')
    finally:
        torch.cuda.empty_cache()


def serve_peak_estimate_gb(cfg) -> float:
    """The roi key mode's eval forward peak, reckoned from its shapes in
    bf16 (the per-query keys dominate): the gathered cells [R, Cc*49, 2C]
    and, in a decoder layer's cross-attention, keys + key_pos, the two
    projections, their float32 casts in `multi_head_attention` and the
    float32 copy that each batched matmul makes of its transposed operand
    (three [R, Cc*49, C] float32 tensors live at once), plus 2 GiB for the
    rest of the forward."""
    R = cfg.total_views * cfg.proposal_test.max_per_img
    Cc = 1 + R if cfg.correlation.mode == 'all_matched' else \
        1 + cfg.total_views * min(cfg.correlation.topk,
                                  cfg.proposal_test.max_per_img)
    n = R * Cc * cfg.roi_size ** 2 * cfg.embed_dims    # one [R, Kq, C]
    return (2 * n * 2 + 3 * n * 2 + 3 * n * 4) / 2 ** 30 + 2.0


def phase_routes_tiny(dev):
    """The optional routes at a small size, float32 with TF32 off, GPU
    (kernels) against CPU (plain versions): a ResNet-50 backbone with
    MV2D-T's DCN layout on 2 views at 256x704 built with
    fused_stages='all' (layer2's three tail blocks through B10; every
    stage output within 1e-4 of its max magnitude; with gradients on, no
    B10 and a gradient in layer2's tail), then one tiny+DCN training step
    with dcn_train_fused and flash_sparse (phase_tiny_train's checks, with
    K2, B13 and B8 launched and B5 and B6's wrappers not called: B13 runs
    B6's walk inside its own C entry), and one with align_v2 (B11 and B9
    launched, K3 not)."""
    import torch
    from mv2d_tpu_torch.nn.resnet import ResNet
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import init_random_weights
    net = init_random_weights(ResNet(50, (False, False, True, True),
                                     Routes(fused_stages='all')),
                              seed=3).eval()
    imgs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 256, 704, 3)).astype(np.float32))
    fns = counters()
    outs, launched = {}, {}
    with torch.no_grad():
        for d in ('cpu', dev):
            for fn in fns.values():
                fn.launches = 0
            outs[d] = [o.float().cpu() for o in net.to(d)(imgs.to(d))]
            launched[d] = {n: fn.launches for n, fn in fns.items()}
    err, rel, finite, same = compare_all(outs[dev], outs['cpu'])
    want = {'fused_stage1': 3, 'fused_identity_chain': 3, 'dcn_conv': 9}
    got = {n: launched[dev][n] for n in want}
    ok = finite and same and rel <= F32_TOL and got == want
    log(f'  backbone R50 (DCN in stages 3-4) 2 x 256x704 with '
        f'fused_stages=all, GPU vs CPU: max_abs_err={err:.3e} '
        f'rel={rel:.2e} (tol {F32_TOL:.0e}), GPU launches {got} '
        f'(expected {want}) {"ok" if ok else "FAIL"}')
    fns['fused_identity_chain'].launches = 0
    with torch.enable_grad():
        sum(o.float().sum() for o in net(imgs.to(dev))).backward()
    b10 = fns['fused_identity_chain'].launches
    g = net.layer2[1].conv1.weight.grad
    grad_ok = b10 == 0 and g is not None and bool(
        torch.isfinite(g).all()) and g.abs().max().item() > 0
    log(f'  the same with gradients on: B10 launches {b10} (expected 0), '
        f'layer2 block 1 conv1 grad max '
        f'{float("nan") if g is None else g.abs().max().item():.3e} '
        f'{"ok" if grad_ok else "FAIL"}')
    ok_train = phase_tiny_train(
        dev, need=('dcn_conv', 'dcn_conv_backward', 'masked_attention',
                   'masked_attention_backward', 'mask_bits',
                   'roi_align_multilevel', 'roi_align_multilevel_backward'),
        absent=('dcn_samples', 'dcn_samples_backward',
                'fused_identity_chain', 'roi_align_slab', 'roi_align_flat'),
        routes=Routes(dcn_train_fused=True, flash_sparse=True))
    ok_v2 = phase_tiny_train(
        dev, need=('dcn_samples', 'dcn_samples_backward', 'masked_attention',
                   'masked_attention_backward', 'roi_align_slab',
                   'roi_align_multilevel_backward', 'mask_bits'),
        absent=('roi_align_multilevel', 'roi_align_flat',
                'fused_identity_chain', 'dcn_conv_backward'),
        routes=Routes(align_v2=True))
    return ok and grad_ok and ok_train and ok_v2


def phase_routes(dev, results, n_requests=2, n_steps=3, cfg=None):
    """Full width on the optional routes: bf16 eval forwards with
    fused_stages='all' (B10 on layer2's tail), then training steps with
    dcn_train_fused, flash_sparse and align_v2 (B13, B8, B11 / B9), each
    beside the default route's ms and peak memory from this run.  B13 runs
    B6's walk inside its own C entry, so B5 and B6's wrappers count no
    launch on the routed step (ROUTED_TRAIN_PER_STEP)."""
    import torch
    import mv2d_tpu_torch.nn.resnet as resnet
    import mv2d_tpu_torch.ops.attention as attention
    import mv2d_tpu_torch.ops.dcn as dcn
    import mv2d_tpu_torch.ops.roi_align as roi_align
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.core.geometry import prepare_camera_params
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.ops import stage
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import (camera_rig, init_random_weights,
                                          synthetic_train_batch)
    from mv2d_tpu_torch.parallel.dist import dp_train_step
    from mv2d_tpu_torch.train.optim import make_optimizer

    cfg = cfg or configs.mv2d_t_r50()
    V, (H, W) = cfg.total_views, cfg.image_size
    fns = counters()
    seen = {}

    def run(paths, n, call, label):
        """n host-timed calls with every counter at 0 first;
        -> (ms list, launches, peak GiB, last result, detect graph)."""
        originals = _record_first(seen, paths)
        for fn in fns.values():
            fn.launches = 0
        graph0 = detect_graph_calls()
        torch.cuda.reset_peak_memory_stats()
        ms, res = [], None
        try:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
        launches = {name: fn.launches for name, fn in fns.items()}
        for name, k in launches.items():
            results[name]['launches_by_path'][label] = k
        return (ms, launches, torch.cuda.max_memory_allocated() / 2 ** 30,
                res, detect_graph_calls(graph0))

    # ---- eval forwards, fused_stages='all' (MV2D_FUSED_STAGES=all)
    K, E = camera_rig(V, cfg.image_size)
    cam = prepare_camera_params(K, E, [0.0] * 6 + [0.5] * 6, device=dev)
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, torch.bfloat16)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    model = init_random_weights(
        MV2D(cfg, Routes(fused_stages='all')).eval(), seed=0).to(
            dev, torch.bfloat16)
    ms, launches, peak, out, _ = run(
        [(resnet, 'fused_identity_chain', 'fused_identity_chain',
          lambda a: True)], n_requests,
        lambda: model(imgs, cam, shapes), 'routes_serve')
    boxes, scores = out[0], out[1]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (boxes, scores))
    serve_ok = finite and tuple(boxes.shape) == (cfg.max_per_scene, 9) \
        and launches['fused_identity_chain'] == 3 * n_requests \
        and launches['mask_bits'] == MASKS_PER_PASS * n_requests
    log(f'  fused_stages=all: forward ms (bf16) '
        + ', '.join(f'{t:.1f}' for t in ms) + ' (default route '
        + ', '.join(f'{t:.1f}' for t in results.get('_forward_ms', []))
        + f'); peak memory {peak:.2f} GiB (default '
        f'{results.get("_serve_peak_gb", float("nan")):.2f}); B10 launches '
        f'per forward {launches["fused_identity_chain"] / n_requests:g} '
        f'(expected 3); finite={finite} {"ok" if serve_ok else "FAIL"}')
    log(f'  launches per {n_requests} forwards: {launches}')
    results['_routes_forward_ms'] = ms
    del model, out, boxes, scores
    torch.cuda.empty_cache()

    # ---- training steps, dcn_train_fused, flash_sparse and align_v2
    # (MV2D_DCN_TRAIN_FUSED=1, MV2D_FLASH_SPARSE=1, MV2D_ALIGN_V2=1)
    model = init_random_weights(
        MV2D(cfg, Routes(dcn_train_fused=True, flash_sparse=True,
                         align_v2=True)), seed=0).to(dev)
    opt = make_optimizer(model)
    batch = synthetic_train_batch(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = []

    def step():
        metrics = dp_train_step(model, opt, [batch], [gen])
        steps.append({k: float(v) for k, v in metrics.items()})

    def cross(args):
        return args[1].shape[0] != args[0].shape[0]
    ms, launches, peak, _, graph = run(
        [(dcn, 'dcn_conv_backward', 'dcn_conv_backward', lambda a: True),
         (attention, 'masked_attention_backward',
          'masked_attention_backward', cross),
         (roi_align, 'roi_align_slab', 'roi_align_slab', lambda a: True)],
        n_steps, step, 'routes_train')
    finite = all(np.isfinite(v) for s in steps for v in s.values())
    want = expect_calls(ROUTED_TRAIN_PER_STEP, n_steps, graph,
                        DETECT_CALLS_V2)
    per_step_ok = all(launches[n] == k for n, k in want.items())
    train_ok = finite and per_step_ok
    log(f'  dcn_train_fused, flash_sparse, align_v2: train ms/step '
        + ', '.join(f'{t:.1f}' for t in ms) + ' (default route '
        + ', '.join(f'{t:.1f}' for t in results.get('_train_ms', []))
        + f'); peak memory {peak:.2f} GiB (default '
        f'{results.get("_train_peak_gb", float("nan")):.2f}); '
        f'finite={finite}')
    for i, s in enumerate(steps):
        log(f'  step {i}: total_loss={s["total_loss"]:.4f} '
            f'grad_norm={s["grad_norm"]:.4f}')
    log(f'  wrapper calls in {n_steps} steps: {launches} (want {want}: per '
        f'step {ROUTED_TRAIN_PER_STEP}, where detect\'s graph {graph} '
        f'replays) {"ok" if per_step_ok else "FAIL"}')
    results['_routes_train_ms'] = ms
    results['_routes_train_peak_gb'] = peak
    del model, opt, batch
    torch.cuda.empty_cache()

    def dcn_bwd_plain(x, sy, sx, m, w, dy):
        return plain_grads(dcn.dcn_conv_plain, (x, sy, sx, m, w), range(5),
                           dy)[1]

    plain = {'fused_identity_chain': stage.fused_identity_chain_plain,
             'dcn_conv_backward': dcn_bwd_plain,
             'masked_attention_backward': _attn_bwd_plain,
             'roi_align_slab': roi_align.multilevel_roi_align_plain}
    kern = {'fused_identity_chain': stage.fused_identity_chain,
            'dcn_conv_backward': dcn.dcn_conv_backward,
            'masked_attention_backward': attention.masked_attention_backward,
            'roi_align_slab': roi_align.roi_align_slab}
    return _replay(seen, plain, kern, 'routes') and serve_ok and train_ok


# the train_cli phase: 4 train scenes an epoch, 2 epochs, 2 val scenes
TRAIN_CLI_SCENES, TRAIN_CLI_VAL = 4, 2
SOAK_LOG = 'docs/soak/train_log_r5.jsonl'


def _same_tree(a, b):
    """Equal bit for bit: tensors (on any device) by dtype and value."""
    import torch
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and \
            torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    return a == b


def phase_train_cli(dev, results):
    """The training CLI as a user runs it (`tools.train.main`): render
    TRAIN_CLI_SCENES train and TRAIN_CLI_VAL val scenes of the synthetic
    fixture (2 epochs, the eval hook after each), train MV2D-T R50 from
    the model's own seeded initialisation with --max-steps one epoch
    (leg A), then --auto-resume in a process group of one
    (RANK=0 WORLD_SIZE=1: NCCL, the dp step's all-reduces; leg B), then
    `tools.test` on the last checkpoint."""
    import os
    import tempfile
    import torch
    from mv2d_tpu_torch.data.nuscenes import to_eval_inputs
    from mv2d_tpu_torch.eval import results as res
    from mv2d_tpu_torch.parallel.dist import free_port
    from mv2d_tpu_torch.tools import test as test_cli
    from mv2d_tpu_torch.tools import train as train_cli
    from mv2d_tpu_torch.tools.common import (build_dataset, build_model,
                                             load_cli_config)
    from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture
    from mv2d_tpu_torch.train import checkpoint
    from mv2d_tpu_torch.train.optim import cosine_schedule

    smi = results.get('_smi', '')
    n, epochs = TRAIN_CLI_SCENES, 2
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_cli_')
    restore = checkpoint.restore_checkpoint
    env_keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')
    saved_env = {k: os.environ.get(k) for k in env_keys}
    try:
        t0 = time.perf_counter()
        paths = make_fixture(tmp, scenes=n, val_scenes=TRAIN_CLI_VAL,
                             epochs=epochs, eval_interval=1)
        opts = ['log_interval=1']
        cfg = load_cli_config(paths['config'], opts)
        torch.manual_seed(0)                    # the CLI's own init, seed 0
        init = build_model(cfg)
        frozen = [k for k, p in init.named_parameters() if not p.requires_grad]
        work = os.path.join(tmp, 'work')
        argv = [paths['config'], '--work-dir', work, '--device', dev]
        log(f'  fixture: {n} + {TRAIN_CLI_VAL} scenes at 1600x900 in '
            f'{time.perf_counter() - t0:.1f} s')

        restored = {}

        def recording_restore(path, model, optimizer=None):
            meta = restore(path, model, optimizer)
            restored['optimizer'] = _clone(optimizer.state_dict())
            return meta
        checkpoint.restore_checkpoint = recording_restore
        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        graph0 = detect_graph_calls()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        leg_a = train_cli.main(argv + ['--max-steps', str(n),
                                       '--cfg-options', *opts])
        t2 = time.perf_counter()
        os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                          MASTER_ADDR='127.0.0.1',
                          MASTER_PORT=str(free_port()))
        leg_b = train_cli.main(argv + ['--auto-resume', '--cfg-options',
                                       *opts])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {k: fn.launches for k, fn in fns.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        for name, k in launches.items():
            results[name]['launches_by_path']['train_cli'] = k
        steps, scenes = n * epochs, TRAIN_CLI_VAL * epochs
        # a step and a scene each make one detect; counted eagerly, a step
        # launches K3 twice
        graph = detect_graph_calls(graph0)
        want = expect_calls(
            {k: TRAIN_PER_STEP.get(k, 0) * steps
             + EVAL_PER_FORWARD.get(k, 0) * scenes for k in fns}, 1, graph)
        want['roi_align_multilevel'] += 2 * steps
        launch_ok = launches == want
        log(f'  leg A {t2 - t1:.1f} s (to step {leg_a["step"]}), leg B '
            f'{t3 - t2:.1f} s (resumed from '
            f'{os.path.basename(str(leg_b["resumed_from"]))}, to step '
            f'{leg_b["step"]}); wrapper calls {launches} (want {want}, '
            f'detect graph {graph}) {"ok" if launch_ok else "FAIL"}')

        with open(os.path.join(work, 'train_log.jsonl')) as f:
            lines = [json.loads(line) for line in f]
        step_lines = [r for r in lines if 'step' in r]
        vals = [r for r in lines if 'val_mAP' in r]
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               SOAK_LOG)) as f:
            jax_keys = set(json.loads(f.readline()))
        base_lr = cfg['optimizer']['lr']
        log_ok = (leg_a['step'] == n and leg_b['step'] == steps
                  and leg_b['resumed_from'] == os.path.join(work,
                                                            'epoch_1.pth')
                  and [r['step'] for r in step_lines] == list(
                      range(1, steps + 1))
                  and [r['epoch'] for r in vals] == [1, 2]
                  and all(jax_keys <= set(r) for r in step_lines)
                  and all(np.isfinite(v) for r in step_lines
                          for v in r.values())
                  and step_lines[n]['lr'] == cosine_schedule(n, base_lr,
                                                             steps))
        ck1 = torch.load(os.path.join(work, 'epoch_1.pth'), weights_only=True)
        ck2 = torch.load(os.path.join(work, 'epoch_2.pth'), weights_only=True)
        resume_ok = _same_tree(restored.get('optimizer'), ck1['optimizer'])
        init_sd = init.state_dict()
        frozen_ok = all(torch.equal(ck2['state_dict'][k], init_sd[k])
                        for k in frozen)
        trainable = [k for k, p in init.named_parameters() if p.requires_grad]
        moved = sum(not torch.equal(ck2['state_dict'][k], init_sd[k])
                    for k in trainable)
        ms = [1e3 / r['sps'] for r in step_lines]
        log(f'  {len(step_lines)} log lines, JAX soak keys, finite, lr of '
            f'step {n + 1} {step_lines[n]["lr"]:.6e} = cosine_schedule('
            f'{n}) {"ok" if log_ok else "FAIL"}; restored AdamW state equal '
            f'to epoch_1.pth {"ok" if resume_ok else "FAIL"}; frozen '
            f'unchanged {frozen_ok}, trained moved {moved}/{len(trainable)}')
        log('  ms/step in the CLI loop (1000 / sps; steps 1 and 5 start an '
            'epoch): ' + ', '.join(f'{t:.1f}' for t in ms)
            + f'; peak memory {peak_gb:.2f} GiB; {smi}')
        for r in step_lines:
            log(f'  step {r["step"]}: total_loss={r["total_loss"]:.4f} '
                f'grad_norm={r["grad_norm"]:.4f} '
                f'key_active={r["key_active"]:.0f} '
                f'key_overflow={r["key_overflow"]:.0f}')

        # tools.test on the last checkpoint (strict=True) against the hook
        out = os.path.join(tmp, 'submission.json')
        ckpt2 = os.path.join(work, 'epoch_2.pth')
        metrics = test_cli.main([paths['config'], ckpt2, '--out', out,
                                 '--device', dev, '--cfg-options', *opts])
        hook = vals[-1]
        line = train_cli.val_line(metrics, epochs)
        hook_ok = all(line[k] == hook[k] for k in ('val_mAP', 'val_NDS'))
        model = build_model(cfg)
        restore(ckpt2, model)
        ev = train_cli.eval_copy(model, cfg, dev)
        dataset = build_dataset(cfg, 'val')
        info = dataset.get_info(0)
        with torch.inference_mode():
            det = ev(*to_eval_inputs(dataset.get_sample(0), dev,
                                     next(ev.parameters()).dtype))
        direct = res.to_nuscenes_submission(
            [info['token']], [res.boxes_to_pred_dict(
                *res.detections_numpy(det), info=info)],
            {info['token']: info})['results'][info['token']]
        with open(out) as f:
            recs = json.load(f)['results'].get(info['token'], [])
        same, err = _records_close(recs, direct)
        match_ok = same and err <= SELF_TOL
        log(f'  tools.test on epoch_2.pth: mAP {line["val_mAP"]} NDS '
            f'{line["val_NDS"]} vs the hook\'s {hook["val_mAP"]} '
            f'{hook["val_NDS"]} {"ok" if hook_ok else "FAIL"} (whole val '
            f'line equal: {line == hook}); scene 0 vs a forward of the '
            f'hook\'s copy: same boxes {same}, error {err:.2e} (tol '
            f'{SELF_TOL:.0e}) {"ok" if match_ok else "FAIL"}')
        results['_train_cli'] = dict(ms=ms, peak_gb=peak_gb)
        # the tools phase publishes and fuses the last checkpoint
        KEEP['train_cli'] = dict(config=paths['config'], ckpt=ckpt2,
                                 opts=opts, metrics=metrics)
        del ev, model
    finally:
        checkpoint.restore_checkpoint = restore
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        KEEP.setdefault('dirs', []).append(tmp)
        torch.cuda.empty_cache()
    return (launch_ok and log_ok and resume_ok and frozen_ok
            and moved >= 0.9 * len(trainable) and hook_ok and match_ok)


# the exported program's kernel nodes: EVAL_PER_FORWARD by operator
EXPORT_NODES = {'mv2d.bottleneck.default': 3, 'mv2d.dcn_conv.default': 9,
                'mv2d.roi_align.default': 1,
                'mv2d.masked_attention.default': 12,
                'mv2d.mask_bits.default': MASKS_PER_PASS,
                'mv2d.nms_keep.default': NMS_PER_DETECT}
# run in a fresh process: load the program with the operators and no model
# code, run it n times on the saved inputs, save outputs, ms and launches
LOAD_AND_RUN = """
import sys, time, torch
import mv2d_tpu_torch.ops.library
import chip_smoke
path, inputs, out, n, dev = sys.argv[1:]
program = torch.export.load(path).module()
args = [a.to(dev) for a in torch.load(inputs)]
sync = torch.cuda.synchronize if dev == 'cuda' else lambda: None
fns = chip_smoke.counters()
for fn in fns.values():
    fn.launches = 0
ms = []
with torch.inference_mode():
    for _ in range(int(n)):
        sync()
        t0 = time.perf_counter()
        res = program(*args)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
torch.save(dict(out=[r.cpu() for r in res], ms=ms,
                launches={k: fn.launches for k, fn in fns.items()},
                model_code=sorted(m for m in sys.modules
                                  if m.startswith('mv2d_tpu_torch.models'))),
           out)
"""


def phase_export(dev, results, n_runs=4, cfg=None):
    """`tools.export` of MV2D-T R50 in bfloat16 at full width on the serve
    phase's seeded weights and inputs: the program's kernel nodes
    (EXPORT_NODES); the .pt2 loaded in a fresh process that imports only
    the operators (`mv2d_tpu_torch.ops.library`), run n_runs times there:
    its detections equal bit for bit to a direct forward of the same
    signature (`tools.export.ServeForward`, the same operators in the same
    order), its launches n_runs x EVAL_PER_FORWARD and no model module
    imported; ms a scene of the loaded program (there) and of the direct
    forward (here), the first run of each a warm-up."""
    import collections
    import os
    import tempfile
    import torch
    from mv2d_tpu_torch import configs
    from mv2d_tpu_torch.models.mv2d import MV2D
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import init_random_weights
    from mv2d_tpu_torch.tools import export

    cfg = cfg or configs.mv2d_t_r50()
    V, (H, W) = cfg.total_views, cfg.image_size
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32))
    dtype = torch.bfloat16 if dev == 'cuda' else torch.float32
    model = init_random_weights(MV2D(cfg, Routes()).eval(), seed=0).to(
        dev, dtype)
    args = export.example_inputs(cfg, dev, dtype, imgs)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_export_')
    KEEP.setdefault('dirs', []).append(tmp)
    t0 = time.perf_counter()
    program = export.export_model(model, args)
    export_s = time.perf_counter() - t0
    nodes = dict(collections.Counter(export.mv2d_nodes(program)))
    path = os.path.join(tmp, export.PROGRAM)
    torch.export.save(program, path)
    inputs, out = os.path.join(tmp, 'inputs.pt'), os.path.join(tmp, 'out.pt')
    torch.save([a.cpu() for a in args], inputs)
    del program
    nodes_ok = nodes == EXPORT_NODES
    log(f'  exported in {export_s:.1f} s, {os.path.getsize(path) / 2**20:.1f}'
        f' MiB; kernel nodes {nodes} {"ok" if nodes_ok else "FAIL"}')

    fwd = export.ServeForward(model)
    direct_ms = []
    sync = torch.cuda.synchronize if dev == 'cuda' else (lambda: None)
    with torch.inference_mode():
        for _ in range(n_runs):
            sync()
            t1 = time.perf_counter()
            want = fwd(*args)
            sync()
            direct_ms.append((time.perf_counter() - t1) * 1e3)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t2 = time.perf_counter()
    r = subprocess.run([sys.executable, '-c', LOAD_AND_RUN, path, inputs,
                        out, str(n_runs), dev], cwd=tmp, env=env,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        log(r.stdout[-3000:] + r.stderr[-5000:])
        return False
    got = torch.load(out)
    same = all(torch.equal(w.cpu(), g) for w, g in zip(want, got['out']))
    errs = [float((w.cpu().float() - g.float()).abs().max())
            for w, g in zip(want, got['out'])]
    launches = got['launches']
    for name, n in launches.items():
        results[name]['launches_by_path']['export'] = n
    wanted = {k: n_runs * EVAL_PER_FORWARD.get(k, 0) for k in launches}
    launch_ok = launches == wanted
    alone = not got['model_code']
    valid = int(got['out'][3].sum())
    log(f'  loaded in a fresh process ({time.perf_counter() - t2:.1f} s, '
        f'model modules imported: {got["model_code"] or "none"}): '
        f'detections equal to the direct forward bit for bit {same} (max '
        f'abs differences boxes, scores, labels, valid {errs}), '
        f'{valid} valid; launches {launches} (want {wanted}) '
        f'{"ok" if launch_ok else "FAIL"}')
    log('  ms/scene, loaded program: '
        + ', '.join(f'{t:.1f}' for t in got['ms'])
        + '; direct forward: ' + ', '.join(f'{t:.1f}' for t in direct_ms)
        + f' ({str(dtype)[6:]}, {V} views at {H}x{W}; first of each a '
        'warm-up); '
        + results.get('_smi', ''))
    # the host's share: the operators each form dispatches a forward
    # (counted here, on the same inputs)
    from mv2d_tpu_torch.tools.get_flops import OpTally
    calls = {}
    with torch.inference_mode():
        for name, fn in (('direct', fwd),
                         ('loaded', torch.export.load(path).module())):
            with OpTally() as tally:
                fn(*args)
            calls[name] = tally.calls
    log(f'  operators dispatched a forward: {calls}')
    results['_export'] = dict(export_s=export_s, loaded_ms=got['ms'],
                              direct_ms=direct_ms, same=same, calls=calls)
    del model, fwd
    return nodes_ok and same and launch_ok and alone and valid > 0


def _printed_metrics(stdout: str) -> dict:
    """mAP and NDS as `tools.test` prints them (rounded to 4 places)."""
    out = {}
    for line in stdout.splitlines():
        for k in ('mAP', 'NDS'):
            if line.strip().startswith(f'"{k}":'):
                out[k] = float(line.split(':')[1].strip(' ,'))
    return out


def phase_tools(dev, results, options=()):
    """The port's other user tools on the card: `get_flops` at full width
    (params, GFLOPs, bytes), `benchmark --bf16` 5 + 20 iterations,
    `dist_test.sh` with GPUS=1 (torchrun, an NCCL group of one) on the
    eval phase's rendered scenes and weights (its submission equal to that
    phase's, its mAP / NDS equal to that phase's rounded as printed),
    `misc publish` and `misc fuse_conv_bn` on train_cli's last checkpoint,
    each loaded by `tools.test` (strict=True; the published file's metrics
    equal to train_cli's test of the checkpoint, the fused one's finite),
    `visualize --cameras` of one scene to a PNG, and
    `utils.profiling.trace` around one forward (its trace written, with
    the kernels' device time).  `options` (--cfg-options) shrink the
    full-width runs for a rehearsal."""
    import os
    import tempfile
    import torch
    from mv2d_tpu_torch.parallel.dist import free_port
    from mv2d_tpu_torch.routes import Routes
    from mv2d_tpu_torch.synthetic import init_random_weights
    from mv2d_tpu_torch.tools import benchmark, get_flops, misc, visualize
    from mv2d_tpu_torch.tools import test as test_cli
    from mv2d_tpu_torch.tools.common import build_model, load_cli_config
    from mv2d_tpu_torch.tools.export import rig_camera
    from mv2d_tpu_torch.utils import profiling

    smi = results.get('_smi', '')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_tools_')
    KEEP.setdefault('dirs', []).append(tmp)
    ok = True

    t0 = time.perf_counter()
    opts = ['--device', dev, '--cfg-options', *options]
    flops = get_flops.main([R50_FILE, *opts])
    log(f'  get_flops ({time.perf_counter() - t0:.1f} s): '
        f'{flops["params"]} params, {flops["flops"] / 1e9:.2f} GFLOPs, '
        f'{flops["bytes"] / 1e9:.2f} GB; {smi}')
    results['_flops'] = flops
    ok &= flops['flops'] > 0 and set(flops['ops']) == {
        'mv2d.' + k.split('.')[1] for k in EXPORT_NODES}

    bench = benchmark.main([R50_FILE, '--bf16', '--warmup', '5', '--iters',
                            '20', *opts])
    results['_benchmark'] = bench
    ok &= np.isfinite(bench['samples_per_s'])

    ev = KEEP['eval']
    root = os.path.dirname(os.path.abspath(__file__))
    out2 = os.path.join(tmp, 'submission_dist.json')
    t1 = time.perf_counter()
    r = subprocess.run(
        ['bash', os.path.join(root, 'mv2d_tpu_torch/tools/dist_test.sh'),
         R50_FILE, ev['pth'], '--out', out2, '--device', dev,
         '--cfg-options', *ev['opts']],
        cwd=root, env=dict(os.environ, GPUS='1', PORT=str(free_port()),
                           PYTHON=sys.executable),
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        log(r.stdout[-3000:] + r.stderr[-5000:])
        return False
    with open(ev['out']) as f:
        sub1 = json.load(f)['results']
    with open(out2) as f:
        sub2 = json.load(f)['results']
    printed = _printed_metrics(r.stdout)
    want = {k: round(float(ev['metrics'][k]), 4) for k in ('mAP', 'NDS')}
    dist_ok = sub1 == sub2 and printed == want
    log(f'  dist_test.sh GPUS=1 ({time.perf_counter() - t1:.1f} s, torchrun,'
        f' NCCL): submission equal to the eval phase\'s {sub1 == sub2}, '
        f'mAP / NDS {printed} (eval phase {want}) '
        f'{"ok" if dist_ok else "FAIL"}')
    ok &= dist_ok

    tc = KEEP['train_cli']
    pub, fused = os.path.join(tmp, 'published.pth'), os.path.join(
        tmp, 'fused.pth')
    misc.main(['publish', tc['ckpt'], pub])
    misc.main(['fuse_conv_bn', tc['ckpt'], fused])
    m_pub = test_cli.main([tc['config'], pub, '--device', dev,
                           '--cfg-options', *tc['opts']])
    m_fused = test_cli.main([tc['config'], fused, '--device', dev,
                             '--cfg-options', *tc['opts']])
    keys = ('mAP', 'NDS')
    misc_ok = (all(m_pub[k] == tc['metrics'][k] for k in keys)
               and all(np.isfinite(m_fused[k]) for k in keys)
               and 'optimizer' not in torch.load(pub, weights_only=True))
    log(f'  misc publish: tools.test mAP / NDS '
        f'{[m_pub[k] for k in keys]} (the checkpoint\'s '
        f'{[tc["metrics"][k] for k in keys]}); fuse_conv_bn: '
        f'{[m_fused[k] for k in keys]} {"ok" if misc_ok else "FAIL"}')
    ok &= misc_ok

    png = os.path.join(tmp, 'vis.png')
    vis = visualize.main([R50_FILE, '--checkpoint', ev['pth'], '--cameras',
                          '--out', png, '--score-thr', '0.0', '--device',
                          dev, '--cfg-options', *ev['opts']])
    vis_ok = os.path.getsize(png) > 0 and vis['gts'] > 0
    log(f'  visualize: {vis} {os.path.getsize(png)} bytes '
        f'{"ok" if vis_ok else "FAIL"}')
    ok &= vis_ok

    cfg = load_cli_config(R50_FILE, options)
    model = init_random_weights(build_model(cfg, Routes()), seed=0).eval()
    dtype = torch.bfloat16 if dev == 'cuda' else torch.float32
    model = model.to(dev, dtype)
    mc = model.cfg
    V, (H, W) = mc.total_views, mc.image_size
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(V, H, W, 3)).astype(np.float32)).to(dev, dtype)
    cam = rig_camera(mc, dev)
    shapes = torch.tensor([[H, W]] * V, device=dev)
    log_dir = os.path.join(tmp, 'trace')
    with torch.inference_mode():
        model(imgs, cam, shapes)
        with profiling.trace(log_dir) as prof:
            with profiling.annotate('forward'):
                model(imgs, cam, shapes)
    trace_file = os.path.join(log_dir, profiling.TRACE_FILE)
    dev_us = {e.key: e.device_time_total for e in prof.key_averages()
              if e.key.startswith('mv2d::')}
    trace_ok = os.path.getsize(trace_file) > 0 and len(dev_us) > 0
    log(f'  profiling.trace: {os.path.getsize(trace_file) / 2**20:.1f} MiB '
        f'trace; device us under each operator {dev_us} '
        f'{"ok" if trace_ok else "FAIL"}')
    ok &= trace_ok
    del model
    torch.cuda.empty_cache()
    return bool(ok)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False')
    from mv2d_tpu_torch import configs, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = 'cuda'
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f'python {sys.version.split()[0]} torch {torch.__version__} '
        f'cuda {torch.version.cuda}; {smi}')
    results = {name: dict(name=name, route='cuda', **info, launches=0,
                          launches_by_path={}, max_abs_err=None, ms=None,
                          plain_ms=None, bound_ms=None, bound_by=None,
                          library_ms=None)
               for name, info in KERNELS.items()}
    results['_smi'] = smi

    failed = []
    t0 = time.perf_counter()
    log('[build]')
    lib = kernels.build(verbose=True)
    kernels.lib()
    log(f'  built {lib.name} in {time.perf_counter() - t0:.1f} s')
    for phase, fn in (
            ('kernels', lambda: phase_kernels(dev, results)),
            ('tiny', lambda: phase_tiny_parity(dev)),
            ('tiny_train', lambda: phase_tiny_train(dev)),
            ('variants_tiny', lambda: phase_variants_tiny(dev)),
            ('serve', lambda: phase_serve(dev, results)),
            ('serve_s', lambda: phase_serve(
                dev, results, cfg=configs.mv2d_s_r50(), label='serve_s')),
            ('serve_v99', lambda: phase_serve(
                dev, results, 2, configs.mv2d_t_v99(), 'serve_v99')),
            ('serve_all', lambda: phase_serve(
                dev, results, 2, all_matched(configs.mv2d_t_r50()),
                'serve_all')),
            ('serve_s_all', lambda: phase_serve_s_all(dev, results)),
            ('export', lambda: phase_export(dev, results)),
            ('http', lambda: phase_http(dev, results)),
            ('eval', lambda: phase_eval(dev, results)),
            ('parity', lambda: phase_parity(dev, results)),
            ('stages', lambda: phase_stages(dev, results)),
            ('train', lambda: phase_train(dev, results)),
            ('train_s', lambda: phase_train_s(dev, results)),
            ('train_remat', lambda: phase_train_remat(dev, results)),
            ('routes_tiny', lambda: phase_routes_tiny(dev)),
            ('routes', lambda: phase_routes(dev, results)),
            ('train_cli', lambda: phase_train_cli(dev, results)),
            ('tools', lambda: phase_tools(dev, results))):
        log(f'[{phase}]')
        t1 = time.perf_counter()
        try:
            good = fn()
        except Exception as e:          # a phase that raises has failed
            import traceback
            traceback.print_exc()
            log(f'  {phase} raised {type(e).__name__}: {e}')
            good = False
        log(f'  {phase}: {"ok" if good else "FAILED"} '
            f'({time.perf_counter() - t1:.1f} s)')
        if not good:
            failed.append(phase)
    import shutil
    for d in KEEP.get('dirs', []):
        shutil.rmtree(d, ignore_errors=True)
    log(f'total {time.perf_counter() - t0:.1f} s')
    if failed:
        log(f'chip_smoke: failed phases {failed}')
        sys.exit(1)
    for r in results.values():
        if isinstance(r, dict) and 'launches_by_path' in r:
            r['launches'] = sum(r['launches_by_path'].values())
    log(json.dumps({'kernels': [results[n] for n in KERNELS]}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
