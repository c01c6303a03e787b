"""The NLM design tool's source edits (tools/nlm_design.py), on the CPU: each
build of ``BUILDS`` changes exactly the constants it names in ops/csrc/nlm.cu,
and ptxas' report is read per kernel.  The tool's builds and timings run only
on the GPU."""
import re

import pytest

from ecg_representation_learning_tpu_torch.ops import _build
from ecg_representation_learning_tpu_torch.tools import nlm_design

SOURCE = (_build.CSRC / 'nlm.cu').read_text()


def changed_lines(a: str, b: str):
    return [(x, y) for x, y in zip(a.splitlines(), b.splitlines()) if x != y]


@pytest.mark.parametrize('name', sorted(nlm_design.BUILDS))
def test_each_build_sets_only_its_constants(name):
    change = nlm_design.BUILDS[name]
    text = nlm_design.variant_source(SOURCE, change)
    assert len(text.splitlines()) == len(SOURCE.splitlines())
    lines = changed_lines(SOURCE, text)
    for old, new in lines:
        assert any(k in old and k in new for k in change) or 'EXP ?' in old, (old, new)
    for key, value in change.items():
        if key == 'exp':
            assert f'return EXP ? {value}(' in text
        else:
            assert re.search(rf'constexpr int {key} = {value};', text)
    # a build that asks for the source's own value changes nothing
    assert len(lines) <= len(change)


def test_a_missing_constant_is_an_error():
    with pytest.raises(ValueError, match='not once'):
        nlm_design.variant_source(SOURCE, {'kNoSuchConstant': 3})


def test_ptxas_summary_reads_the_nlm_rows_kernels():
    log = '\n'.join([
        "ptxas info    : Compiling entry function '_ZN1_nlm_res_kernelILb1ELb1ELb1ELb1EEEvNS_6ParamsE'"
        " for 'sm_90a'",
        'ptxas info    : Function properties for _ZN1_nlm_res_kernelILb1ELb1ELb1ELb1EEEvNS_6ParamsE',
        '    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads',
        'ptxas info    : Used 114 registers, used 1 barriers',
        "ptxas info    : Compiling entry function '_ZN1_nlm_res_kernelILb0ELb1ELb1ELb1EEEvNS_6ParamsE'"
        " for 'sm_90a'",
        'ptxas info    : Used 90 registers, used 1 barriers',
    ])
    got = nlm_design.ptxas_summary(log)
    assert list(got) == ['nlm_res_kernel']
    assert '114 registers' in got['nlm_res_kernel'] and '0 bytes spill' in got['nlm_res_kernel']
