"""Every TPU kernel of the JAX package has a hand kernel in the port.

Scans `mv2d_tpu/ops/pallas_*.py` as text for its `pl.pallas_call` sites
and holds each against `chip_smoke.KERNELS`, the port's kernel table (the
one `chip_smoke.py` reports on the card): some kernel's `replaces` names
the site's `file:line`, and that kernel's `source` file exists.  One case
per site.
"""
import re
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CALL = re.compile(r'\bpl\.pallas_call\(')
LABEL = re.compile(r'(mv2d_tpu/ops/pallas_\w+\.py):(\d+)((?:\s+and\s+:\d+)*)')


def pallas_sites():
    """'mv2d_tpu/ops/pallas_x.py:line' of every pl.pallas_call."""
    sites = []
    for path in sorted((ROOT / 'mv2d_tpu' / 'ops').glob('pallas_*.py')):
        rel = path.relative_to(ROOT).as_posix()
        for no, line in enumerate(path.read_text().splitlines(), 1):
            if CALL.search(line):
                sites.append(f'{rel}:{no}')
    return sites


def named_sites(replaces):
    """The file:line sites a `replaces` label names ('f.py:1 and :2' names
    two)."""
    out = set()
    for m in LABEL.finditer(replaces):
        out.add(f'{m.group(1)}:{m.group(2)}')
        out.update(f'{m.group(1)}:{n}'
                   for n in re.findall(r':(\d+)', m.group(3)))
    return out


SITES = pallas_sites()


def test_scan_finds_every_site():
    assert len(SITES) == 13, SITES


def test_labels_name_sites_as_the_table_writes_them():
    assert named_sites('mv2d_tpu/ops/pallas_attention.py:328 and :491') == {
        'mv2d_tpu/ops/pallas_attention.py:328',
        'mv2d_tpu/ops/pallas_attention.py:491'}


@pytest.mark.parametrize('site', SITES)
def test_site_has_a_port_kernel(site):
    owners = [name for name, info in chip_smoke.KERNELS.items()
              if site in named_sites(info['replaces'])]
    assert owners, f'no kernel of chip_smoke.KERNELS replaces {site}'
    for name in owners:
        assert (ROOT / chip_smoke.KERNELS[name]['source']).is_file(), name
