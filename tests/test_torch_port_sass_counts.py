"""The parsing half of ``seghiero_torch.ops.sass_counts`` (the SASS itself
comes from ``cuobjdump`` on the card): registers and spills from a
``ptxas -v`` log, and the opcodes it counts."""

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.ops import sass_counts

LOG = """== rmi_gram.cu
ptxas info    : Compiling entry function '_ZN8seghiero13gram18_kernelILb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN8seghiero13gram18_kernelILb0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers, 15648 bytes smem
ptxas info    : Compiling entry function '_ZN8seghiero16grad_maps_kernelILb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN8seghiero16grad_maps_kernelILb1EEEvPKf
    88 bytes stack frame, 84 bytes spill stores, 148 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8968 bytes smem
"""


def test_ptxas_usage_reads_each_kernels_registers_and_spills():
    assert sass_counts.ptxas_usage(LOG, "gram18_kernelILb0E") == {
        "registers": 124, "spill_store_bytes": 0, "spill_load_bytes": 0}
    assert sass_counts.ptxas_usage(LOG, "grad_maps_kernelILb1E") == {
        "registers": 128, "spill_store_bytes": 84, "spill_load_bytes": 148}
    assert sass_counts.ptxas_usage(LOG, "gram18_kernelILb1E") == {
        "registers": None, "spill_store_bytes": None, "spill_load_bytes": None}


def test_mnemonic_drops_guards_and_padding():
    assert sass_counts._mnemonic("FFMA R1, R2, R3, R1") == "FFMA"
    assert sass_counts._mnemonic("@P0 LDGSTS.E [R1], desc[UR4][R2.64]") == "LDGSTS.E"
    assert sass_counts._mnemonic("@!PT LDS RZ, [RZ]") == ""
    assert sass_counts._count(["LDG.E", "LDGSTS.E", "LDS.128"], "LDG") == 1
