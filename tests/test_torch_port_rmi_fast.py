"""The port's ``rmi_precision: fast`` kernel path, streaming RMI path and
config-4 pieces against the JAX package.

Same inputs (made with numpy from a seed) through ``seghiero_tpu`` and
``seghiero_torch`` on the CPU, f32, at small odd sizes: the plain versions
of kernels #6f–#8f inside the port's ``autograd.Function`` against the
Pallas kernels with bf16 views in interpret mode; the row-chunked
streaming path against JAX's; the 3-level composite loss at a non-4×
logits-to-labels ratio; and ResNet-101's parameter layout. The CUDA
kernels are held against the plain versions by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.hierarchy import Hierarchy as PortHierarchy
from seghiero_torch.losses import fast as port_fast
from seghiero_torch.losses import rmi as port_rmi
from seghiero_torch.models.convert import export_reference_checkpoint, load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.ops import rmi_gram as port_rg
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.hierarchy import Hierarchy as JaxHierarchy
from seghiero_tpu.losses import fast as jax_fast
from seghiero_tpu.losses import rmi as jax_rmi
from seghiero_tpu.models.segmenter import build_model as jax_build_model
from seghiero_tpu.ops.pallas.rmi_gram import rmi_logdet_pallas_cmajor

CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _maps(seed, B=2, C=3, H=34, W=27):
    """One-hot maps of random labels, logits, and per-(b, c) cotangents."""
    rng = np.random.default_rng(seed)
    oh = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, H, W))].transpose(0, 3, 1, 2)
    lg = (rng.standard_normal((B, C, H, W)) * 2).astype(np.float32)
    cot = rng.uniform(0.5, 1.5, (B, C)).astype(np.float32)
    return np.ascontiguousarray(oh), lg, cot


def _jax_value_and_grad(half_fn, oh, lg, cot):
    """Value and d logits of Σ cot · half(one-hot, sigmoid(logits) + 1e-6)."""
    def f(x):
        return jnp.sum(half_fn(jnp.asarray(oh), jax.nn.sigmoid(x) + 1e-6) * cot)

    v, g = jax.jit(jax.value_and_grad(f))(jnp.asarray(lg))
    return float(v), np.asarray(g)


def _port_value_and_grad(half_fn, oh, lg, cot):
    x = torch.from_numpy(lg).requires_grad_()
    v = (half_fn(torch.from_numpy(oh), torch.sigmoid(x) + 1e-6) * torch.from_numpy(cot)).sum()
    v.backward()
    return v.item(), x.grad.numpy()


def test_fast_kernel_path_matches_pallas_interpret():
    """``precision="fast"``: the plain versions of #6f–#8f (inside
    ``_HalfLogdet``) against JAX's Pallas kernels with bf16 views in
    interpret mode, at B=2, C=3, 34×27. Both round the maps, W, y and P to
    bf16 at the same points and add exact f32 products; they differ in the
    f32 order of the sums and where that order puts a y on the other side of
    a bf16 rounding boundary: value rtol 1e-5, gradient rtol 1e-3 / atol
    1e-6 — the parity path's tolerances (test_torch_port_rmi.py), far
    tighter than JAX's own fast-vs-parity 2e-2."""
    oh, lg, cot = _maps(11)
    want = _jax_value_and_grad(
        lambda o, p: rmi_logdet_pallas_cmajor(o, p, interpret=True, precision="fast"), oh, lg, cot)
    got = _port_value_and_grad(
        lambda o, p: port_rg.rmi_logdet_kernel_cmajor(o, p, precision="fast"), oh, lg, cot)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6)
    # and the fast path is not the parity path: bf16 views move the value
    parity = _port_value_and_grad(port_rg.rmi_logdet_kernel_cmajor, oh, lg, cot)
    assert got[0] != parity[0]
    np.testing.assert_allclose(got[0], parity[0], rtol=2e-2)


def test_fast_plain_versions_round_where_the_tpu_kernel_does():
    """The plain fast versions equal the parity versions on inputs that are
    already bf16 (the maps, W, P) except for #7f's rounded residual y."""
    rng = np.random.default_rng(12)
    la = torch.from_numpy(rng.integers(0, 2, (2, 9, 13)).astype(np.float32))
    pr = torch.from_numpy(rng.random((2, 9, 13)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 9, 9)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((2, 9, 18)).astype(np.float32))
    r = port_rg.bf16_round
    assert torch.equal(port_rg.gram18_plain(la, pr, "fast"), port_rg.gram18_plain(r(la), r(pr)))
    assert torch.equal(port_rg.grad_maps_plain(la, pr, p, "fast"),
                       port_rg.grad_maps_plain(r(la), r(pr), r(p)))
    y = r(port_rg._views(r(la)) - r(w).mT @ port_rg._views(r(pr)))
    assert torch.equal(port_rg.residual_gram_plain(la, pr, w, "fast"), y @ y.mT)
    assert not torch.equal(port_rg.residual_gram_plain(la, pr, w, "fast"),
                           port_rg.residual_gram_plain(r(la), r(pr), r(w)))
    with pytest.raises(ValueError, match="precision"):
        port_rg.gram18(la, pr, "bf16")


def test_streaming_matches_jax_streaming():
    """The row-chunked streaming path against JAX's
    ``rmi_logdet_streaming_cmajor`` with 8-row chunks (32 = 4 chunks of
    the 34-row maps' 32 output rows), values and gradients, and against
    the port's materialized op: the same f32 algorithm with its sums
    split over chunks in another order (the tolerances of
    test_torch_port_rmi.py's core test)."""
    oh, lg, cot = _maps(13)
    assert port_rmi._pick_chunk_rows(32, 8) == 8
    want = _jax_value_and_grad(
        lambda o, p: jax_rmi.rmi_logdet_streaming_cmajor(o, p, target_rows=8), oh, lg, cot)
    got = _port_value_and_grad(
        lambda o, p: port_rmi.rmi_logdet_streaming_cmajor(o, p, target_rows=8), oh, lg, cot)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-6)
    B, C, H, W = lg.shape

    def materialized(o, p):
        def nbhd(x):
            return torch.stack([x[:, :, y : y + H - 2, xx : xx + W - 2] for y in range(3)
                                for xx in range(3)], dim=2).reshape(B, C, 9, -1)

        return port_rmi._rmi_logdet_core(nbhd(o), nbhd(p), 9, False)

    core = _port_value_and_grad(materialized, oh, lg, cot)
    np.testing.assert_allclose(got[0], core[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], core[1], rtol=1e-3, atol=1e-6)


def test_fast_rmi_loss_at_a_non_4x_ratio_matches_jax():
    """The 3-level composite with 17² logits against 67² labels and a 5²
    embedding (config 4's 193 → 769 and 769 → 25 are not integer ratios
    either): the bilinear upsample and the nearest label downsample at
    non-integer ratios, with ``rmi_backend: xla`` (the materialized op on
    both sides), value and gradients, mid-schedule so the triplet term is
    live. Tolerances of test_fast_rmi_hiera_triplet_loss_matches_jax."""
    rng = np.random.default_rng(14)
    jh, ph = JaxHierarchy.from_class_config(CLASSES_3L), PortHierarchy.from_class_config(CLASSES_3L)
    lo = (rng.standard_normal((2, 15, 17, 17)) * 2).astype(np.float32)
    emb = rng.standard_normal((2, 16, 5, 5)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = rng.integers(0, 9, (2, 67, 67)).astype(np.int32)
    labels[:, 5:11, 3:20] = 255
    # classes 1, 2 (upper group) and 8 (lower) where the 67 → 5 nearest
    # downsample reads (rows and columns 0, 13, 26, 40, 53)
    for lbl, (y, x) in zip((1, 2, 8, 5), ((0, 0), (0, 26), (26, 0), (40, 40))):
        labels[:, y, x] = lbl
    step = 30_000
    jloss = jax_fast.FastRMIHieraTripletLoss(jh, rmi_backend="xla", hiera_precision="parity")

    def f(lo_, emb_):
        return jloss(jnp.int32(step), jnp.transpose(emb_, (0, 2, 3, 1)), None,
                     jnp.transpose(lo_, (0, 2, 3, 1)), jnp.asarray(labels))

    v, (g_lo, g_emb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(lo),
                                                                      jnp.asarray(emb))
    ploss = port_fast.FastRMIHieraTripletLoss(ph, rmi_backend="xla", rmi_precision="fast")
    lo_t, emb_t = torch.from_numpy(lo).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    got = ploss(step, emb_t, None, lo_t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(lo_t.grad.numpy(), np.asarray(g_lo), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(emb_t.grad.numpy(), np.asarray(g_emb), rtol=1e-4, atol=1e-7)
    assert np.abs(emb_t.grad.numpy()).max() > 0  # the triplet term is live


def test_resnet101_layout_matches_jax():
    """ResNet-101 (config 4's backbone) with the heads: the checkpoint the
    port's converter makes of JAX's variables — shapes from
    ``jax.eval_shape`` of the init, no compute — loads into the port's
    model with ``strict=True``, and every state-dict entry has JAX's shape."""
    d = {"classes": CLASSES_3L,
         "model": {"depth": 101, "dtype": "float32", "aspp_channels": 32, "c1_channels": 8,
                   "proj_dim": 16}}
    jmodel = jax_build_model(JaxConfig.from_dict(d))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 65, 65, 3)),
                                                train=False))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ckpt = export_reference_checkpoint(variables, 101)
    model = port_build_model(PortConfig.from_dict(d))
    load_reference_checkpoint(model, ckpt)
    blocks = {}
    for k in ckpt["backbone_state_dict"]:
        if k.startswith("layer"):
            stage, b = k.split(".")[:2]
            blocks[stage] = max(blocks.get(stage, 0), int(b) + 1)
    assert blocks == {"layer1": 3, "layer2": 4, "layer3": 23, "layer4": 3}
    for part, module in (("backbone_state_dict", model.backbone),
                         ("aspp_head_state_dict", model.aspp_head),
                         ("aux_head_state_dict", model.aux_head)):
        mine = module.state_dict()
        assert set(mine) == set(ckpt[part])
        for k, v in ckpt[part].items():
            assert tuple(mine[k].shape) == tuple(v.shape), (part, k)


def test_train_entry_point_runs_config_4_narrowed_on_cpu(tmp_path, capsys):
    """``python -m seghiero_torch.train --device cpu`` on the config-4 YAML
    narrowed to a CPU drive (depth 18, narrow head, 65² images: every stage
    odd, 17² logits upsampled to 65 at a non-integer ratio, RMI maps of 63
    output rows and columns), ``rmi_precision: fast`` through the plain
    kernels: the epoch table with the super level and a checkpoint."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "example-train-r101-769-hopper.yaml")) as f:
        d = yaml.safe_load(f)
    assert (d["model"]["depth"], d["transform"]["resize"], d["training"]["rmi_precision"]) \
        == (101, [769, 769], "fast")
    d["dataset"]["synthetic_size"] = 4
    d["model"].update(depth=18, dtype="float32", aspp_channels=16, c1_channels=8, proj_dim=8,
                      dilations=[1, 2, 3, 4])
    d["training"].update(num_workers=0, log_every=1)
    d["transform"] = {"resize": [65, 65], "hflip_prob": 0.0}
    d["output"] = {"checkpoint_dir": str(tmp_path), "project_name": "port4"}
    path = tmp_path / "tiny4.yaml"
    path.write_text(yaml.safe_dump(d))
    port_rg.gram18_fast_launches = 0
    assert port_train_main(["--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "has_super=True, n_super=2" in out and "Val super mIoU" in out
    assert (tmp_path / "port4" / "step_00000002" / "model.pth").exists()
    assert port_rg.gram18_fast_launches == 0  # the CPU runs the plain versions


CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "seghiero_torch", "csrc", "rmi_gram.cu")


def _mma_tables():
    """Kernel #7f's tables (``kWordRow``, ``kWordCol``, ``kSlotView``,
    ``kRowView``), pair-ring constants (``kPair*``) and tile sizes
    (``kResTile*``), read from its source."""
    with open(CU) as f:
        src = f.read()
    arr = {k: [int(x) for x in v.split(",")] for k, v in
           re.findall(r"__constant__ int (\w+)\[\d+\] = \{([^}]*)\};", src)}
    num = {k: int(v) for k, v in re.findall(r"constexpr int (k(?:Pair|ResTile)\w+) = (\d+);", src)}
    return arr, num


def _frag_a(lane):
    """PTX mma.m16n8k16 A fragment (16×16, row-major) of one lane: its 4
    registers' (row, col) pairs, low half first."""
    g, t = lane // 4, lane % 4
    return [[(g + 8 * (r % 2), 2 * t + 8 * (r // 2) + e) for e in (0, 1)] for r in range(4)]


def _frag_b(lane):
    """The B fragment (16×8, K × N): 2 registers' (k, n) pairs."""
    g, t = lane // 4, lane % 4
    return [[(2 * t + 8 * r + e, g) for e in (0, 1)] for r in range(2)]


def _frag_c(lane):
    """The C / D fragment (16×8 f32): 4 values' (row, col)."""
    g, t = lane // 4, lane % 4
    return [(g + 8 * (v // 2), 2 * t + v % 2) for v in range(4)]


def _mma_residual(la, pr, w, mask=True):
    """``[BC, 9, 9]`` f32 and Y's zero rows of the Gram ``[BC, 16 − 9, 16]``:
    kernel #7f's arithmetic in torch. Per output row and 16-pixel segment:
    product 1 ``Y = A·B + C``, ``A = −bf16(W)ᵀ`` padded to 16×16 in the
    kernel's row and K-slot orders, ``B`` pr's pair words of the staged row
    (bf16, zero past the map's last column), ``C`` la's views (zero rows
    zero); ``Y`` zero at columns ≥ nw (``mask``), rounded to bf16; ``Y·Yᵀ``
    added to an f32 running sum, read back per pair of views."""
    arr, _ = _mma_tables()
    rows, cols, slots, yrows = arr["kWordRow"], arr["kWordCol"], arr["kSlotView"], arr["kRowView"]
    r = port_rg.bf16_round
    BC, H, W = pr.shape
    nh, nw = H - 2, W - 2
    npx = -(-nw // 16) * 16

    def staged(m):
        x = torch.zeros((BC, H, npx + 3), dtype=torch.float32)
        x[:, :, :W] = r(m)
        return x

    xl, xp = staged(la), staged(pr)
    a1 = torch.zeros((BC, 16, 16), dtype=torch.float32)
    for i, vi in enumerate(yrows):
        for s, vs in enumerate(slots):
            if vi >= 0 and vs >= 0:
                a1[:, i, s] = -r(w)[:, vs, vi]
    out = torch.zeros((BC, 16, 16), dtype=torch.float32)
    for o in range(nh):
        b = torch.stack([xp[:, o + rows[s // 2], cols[s // 2] + s % 2:][:, :npx]
                         for s in range(16)], dim=1)
        c = torch.zeros((BC, 16, npx), dtype=torch.float32)
        for i, v in enumerate(yrows):
            if v >= 0:
                c[:, i] = xl[:, o + v // 3, v % 3:][:, :npx]
        y = a1 @ b + c
        if mask:
            y[:, :, nw:] = 0
        y = r(y)
        for q in range(npx // 16):
            seg = y[:, :, 16 * q:16 * q + 16]
            out += seg @ seg.mT
    live = [i for i, v in enumerate(yrows) if v >= 0]
    order = [live[[yrows[i] for i in live].index(v)] for v in range(9)]
    return out[:, order][:, :, order], out[:, [i for i in range(16) if yrows[i] < 0]]


@pytest.mark.parametrize("shape", [(3, 18, 20), (2, 37, 131), (1, 5, 300), (1, 3, 3)])
def test_residual_fast_as_padded_bf16_products(shape):
    """Kernel #7f's form (csrc/rmi_gram.cu ``residual_mma_kernel``), its
    tables read from the source: ``−bf16(W)ᵀ`` padded to 16×16 in the
    kernel's row and K-slot orders, pr's pair words, C la's views, y masked
    past nw and rounded, f32 sums per 16-pixel segment. Read per pair of
    views it is the plain fast version within 2e-5 of ``yb·ybᵀ`` (the
    card's tolerance), Y's zero rows give exactly 0, and without the mask
    the check fails (every shape here is ragged: nw is not a multiple of
    16)."""
    arr, _ = _mma_tables()
    rows, cols, slots, yrows = arr["kWordRow"], arr["kWordCol"], arr["kSlotView"], arr["kRowView"]
    # each view sits in one K slot, the one its pair word puts there, and in
    # one row of Y; a lane's two words (t, t + 4) lie in one input row
    assert sorted(v for v in slots if v >= 0) == list(range(9))
    assert sorted(v for v in yrows if v >= 0) == list(range(9))
    for s, v in enumerate(slots):
        assert v < 0 or v == 3 * rows[s // 2] + cols[s // 2] + s % 2
    assert rows[:4] == rows[4:]
    rng = np.random.default_rng(21)
    BC, H, W = shape
    la = torch.from_numpy((rng.random((BC, H, W)) < 0.3).astype(np.float32))
    pr = torch.from_numpy((1 / (1 + np.exp(-2 * rng.standard_normal((BC, H, W)))) + 1e-6)
                          .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((BC, 9, 9)) * 0.3).astype(np.float32))
    r = port_rg.bf16_round
    la64, pr64, w64 = la.double(), pr.double(), w.double()
    want = port_rg.residual_gram_plain(la64, pr64, w64, "fast")
    yb = port_rg._views(r(la64)) + r(w64).abs().mT @ port_rg._views(r(pr64))
    tol = 2e-5 * (yb @ yb.mT) + 1e-30
    got, zero = _mma_residual(la, pr, w)
    assert ((got.double() - want).abs() <= tol).all()
    assert not zero.any()
    bad, _ = _mma_residual(la, pr, w, mask=False)
    assert not ((bad.double() - want).abs() <= tol).all()


def test_residual_fast_fragments_follow_the_ptx_layouts():
    """#7f's register algebra, by index: the two product-1 D tiles of a
    segment (pixels 0 … 7 and 8 … 15), packed in pairs, are product 2's A
    fragment of Y (16 rows × 16 pixels); its B fragments of Yᵀ are the same
    registers, {reg0, reg2} for columns 0 … 7 and {reg1, reg3} for 8 … 15.
    And every gather (pr words t and t + 4 at pixel g; la's rows g and
    g + 8 at pixels 2t, 2t + 1, a zero row reading what row g − 6 or row 8
    reads) meets each bank with one word at most, in each rotation of the
    pair ring's slots. The wrapper sizes the partial rows from the kernel's
    tile."""
    arr, num = _mma_tables()
    assert (port_rg.RES_TILE_H, port_rg.RES_TILE_W) == (num["kResTileH"], num["kResTileW"])
    assert port_rg.residual_tiles(769, 769) == 3 * 24
    rows, cols, yrows = arr["kWordRow"], arr["kWordCol"], arr["kRowView"]
    for lane in range(32):
        g, t = lane // 4, lane % 4
        # D tile h holds Y[row][8h + col] at _frag_c; packs (d0, d1), (d2, d3)
        d = [[(i, 8 * h + p) for i, p in _frag_c(lane)] for h in (0, 1)]
        regs = [[d[h][2 * k], d[h][2 * k + 1]] for h in (0, 1) for k in (0, 1)]
        assert regs == _frag_a(lane)  # Y as A: (row, pixel)
        for n0, (lo, hi) in ((0, (0, 2)), (8, (1, 3))):
            # B[k][n] = Yᵀ[pixel k][row n0 + n] = Y[n0 + n][k]
            want = [[(n0 + n, k) for k, n in reg] for reg in _frag_b(lane)]
            assert [regs[lo], regs[hi]] == want
        # product 1: B word t (and t + 4) is the pr pair at pixel g
        for reg, q in zip(_frag_b(lane), (t, t + 4)):
            assert [n for _, n in reg] == [g, g]
            assert [k for k, _ in reg] == [2 * q, 2 * q + 1]
        assert _frag_c(lane)[:2] == [(g, 2 * t), (g, 2 * t + 1)]

    def la_word(r, t):  # (input row, word) of Y's row r at pixel 2t
        v = yrows[r] if yrows[r] >= 0 else (yrows[r - 6] if r < 8 else yrows[8])
        return v // 3, 2 * t + v % 3

    stride, slots = num["kPairStride"], num["kPairSlots"]
    lanes = [(g, t) for g in range(8) for t in range(4)]
    for s in range(slots):
        def at(dy, word):
            return (s + dy) % slots * stride + word

        gathers = ([at(rows[t], cols[t] + g) for g, t in lanes],
                   [at(rows[t + 4], cols[t + 4] + g) for g, t in lanes],
                   [at(*la_word(g, t)) for g, t in lanes],
                   [at(*la_word(g + 8, t)) for g, t in lanes])
        for words in gathers:
            for p0 in (0, 1, 7, 16):  # any first pixel: a shift of every bank
                banks = {}
                for word in set(words):
                    banks.setdefault((word + p0) % 32, set()).add(word)
                assert max(map(len, banks.values())) == 1, (s, p0)
