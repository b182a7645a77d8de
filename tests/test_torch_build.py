"""The port's build helpers, on the CPU.

`cuda_build.ptxas_usage` turns `nvcc -Xptxas -v` output into one line per
kernel (chip_smoke.py prints them).  It needs no nvcc or card.
"""
import pytest

from captra_tpu_torch.ops import cuda_build

_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114fps_cta_kernelILi512ELi8EEEvPKfiiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114fps_cta_kernelILi512ELi8EEEvPKfiiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 59 registers, 512 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118fps_blocked_kernelEPKfiiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118fps_blocked_kernelEPKfiiPi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, 5000 bytes smem, 368 bytes cmem[0]
"""


def test_ptxas_usage_names_each_kernel(monkeypatch):
    monkeypatch.setitem(cuda_build.build_log, "x.cu", _PTXAS)
    assert cuda_build.ptxas_usage("x.cu") == [
        "fps_cta_kernel<512, 8>: Used 59 registers; 0 bytes spill stores, "
        "0 bytes spill loads",
        "fps_blocked_kernel: Used 64 registers; 4 bytes spill stores, "
        "4 bytes spill loads",
    ]
    assert cuda_build.ptxas_usage("not built") == []


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_114fps_cta_kernelILi1024ELi16EEEvPKfiiPi",
     "fps_cta_kernel<1024, 16>"),
    ("_ZN12_GLOBAL__N_115fps_warp_kernelILi16EEEvPKfiiiPi",
     "fps_warp_kernel<16>"),
    ("_ZN12_GLOBAL__N_118fps_cluster_kernelILi5EEEvPKfiiiPi",
     "fps_cluster_kernel<5>"),
    ("_ZN12_GLOBAL__N_118fps_blocked_kernelEPKfiiPi", "fps_blocked_kernel"),
    # the fused set-abstraction kernel's two first-layer routes
    ("_ZN41_GLOBAL__N__49920b4b_9_sa_mlp_cu_3280c32c13sa_mlp_kernelILb1EEEv"
     "NS_4ArgsE", "sa_mlp_kernel<true>"),
    ("_ZN41_GLOBAL__N__49920b4b_9_sa_mlp_cu_3280c32c13sa_mlp_kernelILb0EEEv"
     "NS_4ArgsE", "sa_mlp_kernel<false>"),
    ("not_a_mangled_name", "not_a_mangled_name"),
])
def test_kernel_name_demangles_template_arguments(mangled, name):
    assert cuda_build._kernel_name(mangled) == name
