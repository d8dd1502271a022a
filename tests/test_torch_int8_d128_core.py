"""What kernel 14 at head dim 128 is held to, on the CPU: its three forms on
the attention core's int8 D = 128 kernel (csrc/attn_wgmma.cuh:
attn_i8_d128_wgmma_kernel) and its fp32 "qk" form on split 3xTF32
(csrc/flash_prefix_int8_d128.cu: flash_prefix_i8_qk_tf32_d128_kernel).

The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 2). Here:

- the fragment order of p8 at N = 128: attn_pack_p8's bytes, read lane by
  lane from the m64n128 score accumulator into the 8-bit A fragments of
  the four k32 steps, put key 32kk + 16h + 8j + 2t + e at slot 32kk + 16h +
  4t + 2j + e, _v8_kernel_layout's order; the s32 P.V as two m64n64k32
  products on the v8 tile's d rows 0-63 and 64-127 is p8 . v8 in natural
  order, to the bit, rint(127 p) at its ties included;
- a torch mirror of the core's D = 128 int8 schedule: 128-key tiles, a
  chunk of four (512 keys) in two sweeps (S for the chunk's max, one alpha
  a chunk, S again for p, p8 and P.V), "qkpv"'s P.V through the fragment
  order into two 64-column s32 sums of the chunk, the tiles past kv_len
  skipped. Under "qkpv" its running max and accumulator equal the plain
  version's (ops/flash_prefix.py:_i8_online at I8_KEY_CHUNK) to the bit,
  and so does its output up to the order of the row sum l (fp32 sums of
  the same p); under "qk" (bf16 p times bf16 v, summed tile by tile on
  the tensor cores) it holds the plain version within 1e-5. kv_len 0, 1,
  127-129, 511-513 and n at n 640, keys past kv_len made to win every max
  and values past kv_len at the int8 extremes;
- a numpy mirror of the fp32 "qk" kernel (tests/_tf32_mirror.py:
  i8_qk_d128): S exact on mma.sync .s8 at the K chunk's 144-byte stride
  (to the bit at the fragment level), the 512-key chunk's two sweeps, P.V
  split 3xTF32 a 32-key tile and a 64-column half at a time under
  truncating accumulation, each in an accumulator of its own: within
  F32_ATTN_REL of float64 and of the plain version at its chunk, at the
  same kv_lens with values past kv_len at +-1e4; one TF32 product for P.V
  misses that bound;
- the plain version at its default chunk against the TPU kernel _kernel_i8
  at d = 128 in interpret mode at its default bkv, across the 512-key
  chunk boundary (n 640, kv_len 513 and 600).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _tf32_mirror import _lanes, i8_qk_d128, ldmatrix_x4, mma_16832_s8
from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts

D = 128
TILE = 128
CHUNK = 512
F32_ATTN_REL = 1e-5  # chip_smoke.py: the fp32 attention forms' bound
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def test_the_chunk_is_four_tiles_of_the_kernel():
    assert flash_prefix.I8_KEY_TILE == TILE and flash_prefix.I8_KEY_CHUNK == CHUNK == 4 * TILE


# --- "qkpv": p8 in the fragments of P.V at N = 128 ------------------------------


def slot_keys() -> np.ndarray:
    """The key each of the 128 slots of a P.V A-operand row holds, read
    lane by lane as attn_wgmma.cuh:attn_pack_p8 packs them: register 0 of
    k32 step kk takes s[16kk + 0, 1, 4, 5] (row g, slots 32kk + 4t ..),
    register 1 s[16kk + 2, 3, 6, 7] (row g + 8, the same slots), register 2
    s[16kk + 8, 9, 12, 13] (row g, slots 32kk + 16 + 4t ..), register 3
    s[16kk + 10, 11, 14, 15] (row g + 8); s[i] is row g + 8 ((i >> 1) & 1),
    key 8 (i >> 2) + 2t + (i & 1) of the m64n128 accumulator. Asserts that
    every lane's register holds one row and that the slots of both rows
    agree."""
    regs = ((0, (0, 1, 4, 5)), (8, (2, 3, 6, 7)), (0, (8, 9, 12, 13)), (8, (10, 11, 14, 15)))
    keys = np.full((2, TILE), -1)
    for lane in range(32):
        tt = lane & 3
        for kk in range(TILE // 32):
            for r_i, (dr, idx) in enumerate(regs):
                for byte, i in enumerate(idx):
                    s_i = 16 * kk + i
                    assert 8 * ((s_i >> 1) & 1) == dr  # the register's row
                    slot = 32 * kk + 4 * tt + (16 if r_i >= 2 else 0) + byte
                    key = 8 * (s_i >> 2) + 2 * tt + (s_i & 1)
                    assert keys[dr // 8, slot] in (-1, key)
                    keys[dr // 8, slot] = key
    assert (keys[0] == keys[1]).all()
    return keys[0]


def p8_bits(p: torch.Tensor) -> torch.Tensor:
    """attn_wgmma.cuh:p8_bits: 127 p + 1.5 * 2^23 in fp32, its low byte"""
    y = p.float() * 127.0 + 12582912.0
    return (y.view(torch.int32) & 0xFF).to(torch.int64)


def test_p8_fragments_times_the_v8_tile_halves_is_p8_times_v():
    keys = slot_keys()
    assert sorted(keys) == list(range(TILE))
    rng = np.random.default_rng(128)
    p = torch.from_numpy(rng.uniform(0, 1, (64, TILE)).astype(np.float32))
    p[:, 100:] = 0.0   # masked keys
    p[:, 7] = 1.0      # the row max's own p
    p[0, :8] = (torch.arange(8) + 0.5) / 127.0  # ties of 127 p
    p8 = p8_bits(p)
    assert torch.equal(p8, torch.round(p * 127.0).to(torch.int64))
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, TILE, D)).astype(np.int8))
    vk = flash_prefix._v8_kernel_layout(v8)[0].to(torch.int64)  # [128 d][128 slots]
    for s in range(TILE):  # the layout's slot s holds the key the fragment puts there
        assert torch.equal(vk[:, s], v8[0, keys[s]].to(torch.int64))
    a = p8[:, keys]        # the A operand in slot order
    pv0, pv1 = a @ vk[:64].T, a @ vk[64:].T  # m64n64k32 on d rows 0-63 and 64-127
    assert torch.equal(torch.cat([pv0, pv1], 1), p8 @ v8[0].to(torch.int64))


# --- the core's D = 128 int8 schedule ---------------------------------------------


def core_d128_schedule(q8, k8, v, c, sv, kv_lens, pv_i8: bool):
    """attn_i8_d128_wgmma_kernel's loop in torch: per head ceil(kv_len /
    128) tiles of 128 keys (K, V rows past n zero, as TMA fills them) in
    chunks of four; sweep 1 the chunk's row max of float(S) * c masked at
    kv_len; one alpha a chunk rescales acc and l; sweep 2 S again, p =
    exp2(s - m), p's row sums into l and either p8 (p8_bits) through the
    fragment order (slot_keys) times the v8 tile of the pass's layout, its
    d rows 0-63 and 64-127 apart, into two integer sums of the chunk
    ("qkpv": acc += float(sum) * sv once a chunk) or bf16(p) . v into acc
    ("qk"). Returns (acc, l, m) as _i8_online does. v: the v8 of the pass's
    layout [H, 128, n_pad] int8 ("qkpv") or bf16 [H, n, 128]. The heads run
    side by side: a tile past a head's last valid key is all masked for it
    and changes nothing (max(m, -inf) = m, alpha 1, p 0), the head-by-head
    loop that stops at its own last tile; kv_len 0 keeps m = -inf, l = 0,
    acc = 0 (m enters the exponentials as 0, _i8_online's m_safe)."""
    H, n, d = q8.shape
    lens = kv_lens.clamp(max=n).to(torch.int64)[:, None, None]
    n_tiles = -(-int(lens.max()) // TILE)
    pad = max(n_tiles * TILE - n, 0)
    k8p = torch.nn.functional.pad(k8.double(), (0, 0, 0, pad))
    qd = q8.double()
    keys = torch.from_numpy(slot_keys())
    if pv_i8:
        vkp = torch.nn.functional.pad(v.to(torch.int64), (0, max(n_tiles * TILE - v.shape[2], 0)))
    else:
        vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))

    def scores(j):
        s = (qd @ k8p[:, j * TILE:(j + 1) * TILE].transpose(1, 2)).float() * c[:, None, None]
        col = torch.arange(j * TILE, (j + 1) * TILE)[None, None, :]
        return s.masked_fill(col >= lens, -math.inf)

    acc = torch.zeros((H, n, d))
    l = torch.zeros((H, n, 1))
    m = torch.full((H, n, 1), -math.inf)
    for j0 in range(0, n_tiles, CHUNK // TILE):
        tiles = range(j0, min(j0 + CHUNK // TILE, n_tiles))
        mx = torch.full((H, n, 1), -math.inf)
        for j in tiles:  # sweep 1
            mx = torch.maximum(mx, scores(j).amax(dim=-1, keepdim=True))
        m_new = torch.maximum(m, mx)
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_safe)
        m, l, acc = m_new, alpha * l, acc * alpha
        pv0 = torch.zeros((H, n, 64), dtype=torch.int64)
        pv1 = torch.zeros_like(pv0)
        for j in tiles:  # sweep 2
            p = torch.exp2(scores(j) - m_safe)
            l = l + p.sum(dim=-1, keepdim=True)
            if pv_i8:
                a = p8_bits(p)[..., keys]                # the A fragments' slots
                vt = vkp[:, :, j * TILE:(j + 1) * TILE]  # [H, 128 d][128 slots]
                pv0 += a @ vt[:, :64].transpose(1, 2)
                pv1 += a @ vt[:, 64:].transpose(1, 2)
            else:
                acc = acc + p.to(torch.bfloat16).float() @ vp[:, j * TILE:(j + 1) * TILE]
        if pv_i8:
            acc = acc + torch.cat([pv0, pv1], -1).float() * sv[:, None, None]
    return acc, l, m


# (n, kv_lens): a head with no key, one key, the tile's and the chunk's edges, n
SCHEDULE_CASES = [(640, [0, 1, 127, 128, 129, 511, 512, 513, 640]), (200, [200, 65, 1])]


def _int8_operands(rng, n, lens, pv_i8, past):
    H = len(lens)
    q8 = torch.from_numpy(rng.integers(-127, 128, (H, n, D)).astype(np.int8))
    k8 = torch.from_numpy(rng.integers(-127, 128, (H, n, D)).astype(np.int8))
    if pv_i8:
        v = torch.from_numpy(rng.integers(-127, 128, (H, n, D)).astype(np.int8))
        sv = torch.from_numpy(rng.uniform(1e-5, 1e-4, H).astype(np.float32))
    else:
        v = t(rng.standard_normal((H, n, D)).astype(np.float32)).to(torch.bfloat16)
        sv = torch.zeros(H)
    if past:  # keys past kv_len along q's mean direction win every max; values at the extremes
        for h, L in enumerate(lens):
            k8[h, L:] = (127 * q8[h].float().mean(0).sign()).to(torch.int8)
            v[h, L:] = (127 if pv_i8 else 1e4) * torch.sign(v[h, L:].float() + 0.5).to(v.dtype)
    c = torch.from_numpy(rng.uniform(1e-4, 3e-4, H).astype(np.float32))
    return q8, k8, v, c, sv


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("mode", ["qkpv", "qk"])
@pytest.mark.parametrize("n,lens", SCHEDULE_CASES, ids=[f"n{n}" for n, _ in SCHEDULE_CASES])
def test_the_core_d128_schedule_equals_the_plain_version_at_its_chunk(n, lens, mode, past):
    rng = np.random.default_rng(n + len(lens) + 7 * past)
    pv_i8 = mode == "qkpv"
    q8, k8, v, c, sv = _int8_operands(rng, n, lens, pv_i8, past)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    vk = flash_prefix._v8_kernel_layout(v) if pv_i8 else v
    acc, l, m = core_d128_schedule(q8, k8, vk, c, sv, lens_t, pv_i8)
    acc_p, l_p, m_p = flash_prefix._i8_online(q8, k8, v, c, sv, lens_t, pv_i8, CHUNK)
    assert torch.equal(m, m_p)
    torch.testing.assert_close(l, l_p, rtol=1e-6, atol=0)  # one fp32 sum in another order
    plain = flash_prefix._i8_attention_plain(q8, k8, v, c, sv, lens_t, pv_i8, CHUNK)
    inv = torch.where(l == 0.0, torch.ones_like(l), torch.ones_like(l) / l)
    if pv_i8:
        assert torch.equal(acc, acc_p)
        torch.testing.assert_close(acc * inv, plain, rtol=1e-6, atol=0)
    else:  # bf16 p . v summed tile by tile against one fp32 product a chunk
        torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(acc * inv, plain, rtol=1e-5, atol=1e-5)
    live = lens_t > 0
    assert not plain[~live].any()  # a head with no key gives zeros


# --- fp32 "qk": exact int8 S, split 3xTF32 P.V --------------------------------------

K8_LD = D + 16  # bytes a row of the kernel's K chunk


def scores_i8_d128(q8, k8):
    """flash_prefix_i8_qk_tf32_d128_kernel's S for one warp: q8 [16, 128]
    int8 (its rows; q8_word: bytes 32 ks + 4t and + 16 of rows g, g + 8),
    k8 [8 NT, 128] int8 (keys of a tile) at the K chunk's 144-byte row
    stride, B by ldmatrix_x4 at i8_b_nk_addr, four k32 steps of
    mma.m16n8k32 .s32.s8.s8. Returns [NT][32, 4] int64, accumulator
    layout."""
    lane, g, tt = _lanes()
    qw = np.ascontiguousarray(q8).view(np.uint32)  # [16, 32] words
    qa = [np.stack([qw[g, 8 * ks + tt], qw[g + 8, 8 * ks + tt], qw[g, 8 * ks + 4 + tt],
                    qw[g + 8, 8 * ks + 4 + tt]], 1) for ks in range(4)]
    nt = k8.shape[0] // 8
    tile = np.zeros((k8.shape[0], K8_LD), np.int8)
    tile[:, :D] = k8
    mem = tile.reshape(-1).view(np.uint32)
    acc = np.zeros((nt, 32, 4), np.int64)
    for ks in range(4):
        for np_ in range(nt // 2):
            addr = ((np_ * 16 + (lane & 7) + ((lane >> 4) << 3)) * K8_LD + ks * 32
                    + ((lane >> 3) & 1) * 16)
            b = ldmatrix_x4(mem, addr // 4)
            acc[2 * np_] = mma_16832_s8(qa[ks], b[:, 0:2], acc[2 * np_])
            acc[2 * np_ + 1] = mma_16832_s8(qa[ks], b[:, 2:4], acc[2 * np_ + 1])
    return acc


@pytest.mark.parametrize("draw", ["+-127", "uniform"])
def test_int8_scores_at_d128_are_the_integer_product(draw):
    """S of the fp32 "qk" kernel on the int8 tensor cores, four k32 steps
    over the 128-byte rows at the chunk's 144-byte stride, equals q8 . k8^T
    to the bit (|s| up to 127^2 * 128), for a 32-key tile of sweep 2 and a
    64-key tile of sweep 1."""
    rng = np.random.default_rng(81)
    for keys in (32, 64):
        if draw == "uniform":
            q8, k8 = (rng.integers(-127, 128, (r, D)).astype(np.int8) for r in (16, keys))
        else:
            q8, k8 = (rng.choice(np.array([-127, 127], np.int8), (r, D)) for r in (16, keys))
        acc = scores_i8_d128(q8, k8)
        _, g, tt = _lanes()
        got = np.zeros((16, keys), np.int64)
        for j in range(keys // 8):
            for h in range(2):
                got[g + 8 * h, 8 * j + 2 * tt] = acc[j][:, 2 * h]
                got[g + 8 * h, 8 * j + 2 * tt + 1] = acc[j][:, 2 * h + 1]
        np.testing.assert_array_equal(got, q8.astype(np.int64) @ k8.astype(np.int64).T)


def i8_qk_fp64(q8, k8, v, c, kv_len):
    """kernel 14's fp32 "qk" function in float64: softmax2(float(q8 . k8^T)
    c) over keys [0, kv_len) times v; zeros for kv_len 0"""
    if kv_len == 0:
        return np.zeros((q8.shape[0], v.shape[1]))
    s = (q8.astype(np.float64) @ k8[:kv_len].astype(np.float64).T) * c
    p = np.exp2(s - s.max(1, keepdims=True))
    return (p @ v[:kv_len].astype(np.float64)) / p.sum(1, keepdims=True)


C_QK = np.float32(1.0 / 127.0 ** 2 * LOG2E / math.sqrt(D) * 3.5 ** 2)  # q, k amax 3.5


@pytest.mark.parametrize("kv_len", [0, 1, 127, 128, 129, 511, 512, 513, 640])
def test_fp32_qk_d128_holds_fp32_accuracy(kv_len):
    """The fp32 "qk" kernel's mirror at n 640 (two chunks, the second
    partial) against float64 and against the port's plain version at its
    512-key chunk, within F32_ATTN_REL; values past kv_len at +-1e4 never
    reach o; kv_len 0 gives zeros."""
    n = 640
    rng = np.random.default_rng(900 + kv_len)
    q8, k8 = (rng.integers(-127, 128, (n, D)).astype(np.int8) for _ in range(2))
    v = rng.standard_normal((n, D)).astype(np.float32)
    v[kv_len:] = 1e4 * np.sign(rng.standard_normal((n - kv_len, D)))
    got = i8_qk_d128(q8, k8, v, C_QK, kv_len)
    if kv_len == 0:
        assert not got.any()
        return
    assert rel_err(got, i8_qk_fp64(q8, k8, v, C_QK, kv_len)) <= F32_ATTN_REL
    plain = flash_prefix._i8_attention_plain(
        *(torch.from_numpy(a)[None] for a in (q8, k8, v)), torch.tensor([C_QK]), torch.zeros(1),
        torch.tensor([kv_len], dtype=torch.int32), False, CHUNK)[0]
    assert rel_err(got, plain.numpy()) <= F32_ATTN_REL


def test_fp32_qk_d128_with_one_tf32_pv_misses_the_bound():
    rng = np.random.default_rng(99)
    n = 200
    q8, k8 = (rng.integers(-127, 128, (n, D)).astype(np.int8) for _ in range(2))
    v = rng.standard_normal((n, D)).astype(np.float32)
    want = i8_qk_fp64(q8, k8, v, C_QK, 150)
    assert rel_err(i8_qk_d128(q8, k8, v, C_QK, 150), want) <= F32_ATTN_REL
    assert rel_err(i8_qk_d128(q8, k8, v, C_QK, 150, one=True), want) > F32_ATTN_REL


# --- the plain version against the TPU kernel at d = 128, across a chunk -----------


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
def test_plain_at_d128_matches_the_tpu_kernel_across_the_chunk_boundary(mode):
    """The function the JAX model runs at dim_head 128 (its default bkv,
    512): the port's wrapper on CPU tensors against _kernel_i8 in interpret
    mode, kv_len 513 (one key into the second chunk) and 600. Bounds as
    tests/test_torch_attn_int8.py: "qkpv" one bf16 ulp of the output's scale
    and relative L2 1e-4, "qk" two ulps and 2e-3 (the port rounds p to bf16
    before p.v where the JAX kernel multiplies in fp32)."""
    rng = np.random.default_rng(513)
    n, lens = 640, [513, 600]
    q, k, v = (np.array(jnp.asarray((rng.standard_normal((2, 1, n, D)) * s).astype(np.float32))
                        .astype(jnp.bfloat16).astype(jnp.float32)) for s in (1.5, 1.2, 0.8))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    pv_i8 = mode == "qkpv"
    want = np.asarray(jfp.flash_prefix_attention_i8(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                                                    bq=128, pv_i8=pv_i8).astype(jnp.float32))
    got = flash_prefix.flash_prefix_attention_i8(*(t(x).to(torch.bfloat16) for x in (q, k, v)),
                                                 torch.tensor(lens), pv_i8=pv_i8)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, n, D)
    got = got.float().numpy()
    valid = np.concatenate([got[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    ref = np.concatenate([want[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    ulp = 2.0 ** -8 * max(1.0, np.abs(ref).max())
    diff = np.abs(valid - ref)
    if pv_i8:
        assert diff.max() <= ulp and rel_err(valid, ref) < 1e-4
    else:
        assert diff.max() <= 2 * ulp and rel_err(valid, ref) < 2e-3
