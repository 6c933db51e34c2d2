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


# a made-up kernel in cuobjdump's layout: set-up, then a loop (0x0040 …
# 0x00b0, closed by the backward branch) of 2 packs and 4 tensor-core
# products for its 64 pixels, and an exit
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN8seghiero12_GLOBAL__N_119residual_mma_kernelEPKfS2_S2_Pfiii
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                      /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDGSTS.E [R2], desc[UR4][R4.64] ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LDS R8, [R3] ;
        /*0050*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0060*/                   F2FP.BF16.F32.PACK_AB R20, R13, R12 ;
        /*0070*/                   HMMA.16816.F32.BF16 R12, R4, R9, R12 ;
        /*0080*/                   F2FP.BF16.F32.PACK_AB R21, R15, R14 ;
        /*0090*/                   HMMA.16816.F32.BF16 R24, R20, R20, R24 ;
        /*00a0*/                   HMMA.16816.F32.BF16 R28, R20, R21, R28 ;
        /*00b0*/              @P0 BRA 0x40 ;
        /*00c0*/              @!PT LDS RZ, [RZ] ;
        /*00d0*/                   EXIT ;
"""


def test_mnemonic_reads_tensor_core_products_and_packs():
    assert sass_counts._mnemonic("HMMA.16816.F32.BF16 R12, R4, R8, R12") == \
        "HMMA.16816.F32.BF16"
    assert sass_counts._count(["HMMA.16816.F32.BF16", "F2FP.BF16.F32.PACK_AB", "FFMA"],
                              "HMMA") == 1
    assert sass_counts._count(["F2FP.BF16.F32.PACK_AB", "F2F.F32.F64"], "F2FP") == 1


def test_count_sass_finds_the_tensor_core_loop():
    log = LOG.replace("grad_maps_kernelILb1E", "residual_mma_kernel")
    got = sass_counts.count_sass(SASS, log)
    assert set(got) == {"residual_mma_kernel"}
    k = got["residual_mma_kernel"]
    assert (k["instructions"], k["hmma"], k["ffma"]) == (13, 4, 0)
    assert (k["loop_instructions"], k["loop_hmma"], k["loop_f2fp"], k["loop_lds"],
            k["loop_ldgsts"], k["loop_branches"]) == (8, 4, 2, 1, 0, 1)
    assert k["loop_instructions_per_16_pixels"] == 2.0  # 8 for 64 pixels a warp
    assert (k["registers"], k["spill_store_bytes"]) == (128, 84)
