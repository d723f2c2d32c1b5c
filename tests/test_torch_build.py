"""The port's build helpers (vlite_fast_tpu_torch/_build.py) and the
dedispersion probe's patches, without a card or nvcc."""

import shutil

import pytest

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.benchmarks import rollsel_stages

LOG = """nvcc -gencode arch=compute_90a,code=sm_90a ...
ptxas info    : Compiling entry function 'plain_kernel' for 'sm_90a'
ptxas info    : Function properties for plain_kernel
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Function properties for a_device_function
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114rollsel_stage1ILi32EEEvNS_6S1ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114rollsel_stage1ILi32EEEvNS_6S1ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_kernel(tmp_path):
    log = tmp_path / "lib.log"
    log.write_text(LOG)
    rep = _build.ptxas_report(log)
    assert rep["plain_kernel"] == {"stack": 8, "spill_stores": 4,
                                   "spill_loads": 12, "registers": 128}
    name = "rollsel_stage1<32>" if shutil.which("c++filt") else \
        "_ZN12_GLOBAL__N_114rollsel_stage1ILi32EEEvNS_6S1ArgsE"
    assert rep[name] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                         "registers": 32}
    assert len(rep) == 2          # the device function is no kernel


def test_every_library_has_its_source():
    assert sorted(_build.LIBRARIES) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", sorted(rollsel_stages.VARIANTS))
def test_rollsel_variants_patch_the_source(name):
    """Each variant's edits find their text once in csrc/dedisperse.cu."""
    text = (_build.CSRC / "dedisperse.cu").read_text()
    for old, new in rollsel_stages.VARIANTS[name]:
        assert text.count(old) == 1
        text = text.replace(old, new)
