"""The port's multi-process evaluation on the CPU, over gloo, through its
launchers (`mv2d_tpu_torch/tools/{dist,slurm}_{test,train}.sh`), on a
rendered fixture (`tools.make_synth_fixture`: 3 val scenes at 90x160) and
the tiny preset on its six cameras, two frames, float32:

  * `dist_test.sh` with GPUS=2 (torchrun, two processes, rank r evaluating
    the scenes r, r + 2, ..., rank 0 gathering them) prints the metrics
    of the one-process `tools.test` and writes its submission, bit for bit
    (one thread a process on both sides);
  * `slurm_test.sh` under a stand-in `srun` that starts its tasks on this
    host with SLURM_PROCID / SLURM_NTASKS / SLURM_LOCALID set does the
    same;
  * `dist_train.sh` with GPUS=2 trains an epoch with the eval hook on both
    ranks (rank 0's gather waits for every rank), and the hook's val line
    equals `tools.test` on the epoch's checkpoint in one process.
"""
import json
import os
import stat
import subprocess
import sys

import pytest

torch = pytest.importorskip('torch')

from mv2d_tpu_torch.parallel.dist import free_port       # noqa: E402
from mv2d_tpu_torch.tools.make_synth_fixture import make_fixture  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, 'mv2d_tpu_torch', 'tools')
OPTIONS = ["model.preset='tiny'",
           'model.overrides=dict(num_views=6, num_frames=2)',
           'data.train.final_dim=(64, 96)', 'data.val.final_dim=(64, 96)',
           'log_interval=1']
FAKE_SRUN = """#!/usr/bin/env bash
# stands in for SLURM's srun on one host: --ntasks copies of the command
n=1
while [[ $# -gt 0 ]]; do
  case "$1" in
    --ntasks=*) n=${1#--ntasks=} ;;
    -p) shift ;;
    -*) ;;
    *) break ;;
  esac
  shift
done
export SLURM_NTASKS=$n SLURM_JOB_NODELIST=localhost
pids=()
for ((i = 0; i < n; i++)); do
  SLURM_PROCID=$i SLURM_LOCALID=$i "$@" &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=1; done
exit $rc
"""


def env(**kw):
    return dict(os.environ, PYTHONPATH=REPO, PYTHON=sys.executable,
                OMP_NUM_THREADS='1', **kw)


def run(cmd, **kw):
    r = subprocess.run(cmd, cwd=REPO, env=env(**kw), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def printed_metrics(stdout):
    """The metrics json `tools.test` prints, and its class AP lines."""
    start = stdout.index('{\n')
    end = stdout.index('\n}', start) + 2
    aps = [line for line in stdout.splitlines() if ' AP: ' in line]
    return json.loads(stdout[start:end]), aps


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp('dist_eval')
    paths = make_fixture(str(d), scenes=2, val_scenes=3, objects=6,
                         image_h=90, image_w=160, seed=4, epochs=1,
                         eval_interval=1)
    return d, paths['config']


@pytest.fixture(scope='module')
def one_process(fixture):
    d, cfg = fixture
    out = str(d / 'one.json')
    stdout = run([sys.executable, '-m', 'mv2d_tpu_torch.tools.test', cfg,
                  '--device', 'cpu', '--out', out, '--cfg-options',
                  *OPTIONS])
    with open(out) as f:
        return printed_metrics(stdout), json.load(f)


def test_dist_test_two_processes_equal_one(fixture, one_process):
    d, cfg = fixture
    out = str(d / 'two.json')
    stdout = run(['bash', os.path.join(TOOLS, 'dist_test.sh'), cfg,
                  '--device', 'cpu', '--out', out, '--cfg-options',
                  *OPTIONS], GPUS='2', PORT=str(free_port()))
    with open(out) as f:
        sub = json.load(f)
    (metrics, aps), want = one_process
    assert printed_metrics(stdout) == (metrics, aps)
    assert sub == want and len(sub['results']) == 3


def test_slurm_test_two_tasks_equal_one(fixture, one_process, tmp_path):
    d, cfg = fixture
    for name, text in (('srun', FAKE_SRUN),
                       ('scontrol', '#!/usr/bin/env bash\necho localhost\n')):
        path = tmp_path / name
        path.write_text(text)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    out = str(d / 'slurm.json')
    stdout = run(['bash', os.path.join(TOOLS, 'slurm_test.sh'), 'part',
                  'job', cfg, '--device', 'cpu', '--out', out,
                  '--cfg-options', *OPTIONS], GPUS='2', GPUS_PER_NODE='2',
                 PORT=str(free_port()),
                 PATH=f'{tmp_path}:{os.environ["PATH"]}')
    with open(out) as f:
        assert json.load(f) == one_process[1]
    assert printed_metrics(stdout) == one_process[0]


def test_dist_train_hook_on_every_rank(fixture, tmp_path):
    d, cfg = fixture
    work = str(tmp_path / 'work')
    run(['bash', os.path.join(TOOLS, 'dist_train.sh'), cfg, '--work-dir',
         work, '--device', 'cpu', '--cfg-options', *OPTIONS], GPUS='2',
        PORT=str(free_port()))
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    vals = [r for r in lines if 'val_mAP' in r]
    steps = [r for r in lines if 'step' in r]
    assert len(vals) == 1 and len(steps) == 1     # 2 scenes, 2 ranks
    stdout = run([sys.executable, '-m', 'mv2d_tpu_torch.tools.test', cfg,
                  os.path.join(work, 'epoch_1.pth'), '--device', 'cpu',
                  '--cfg-options', *OPTIONS])
    metrics, _ = printed_metrics(stdout)
    for k, v in metrics.items():
        assert round(vals[0][f'val_{k}'], 4) == v, k
