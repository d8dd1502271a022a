"""What kernel 14 on the attention core's int8 form (csrc/flash_prefix_int8.cu
on csrc/attn_wgmma.cuh) and its quantization pass (csrc/quant_heads.cu) are
held to, on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 2, which hold them to these plain versions: the pass to the bit). Here:

- the pass's plain semantics (quantize_heads on CPU tensors): q8, k8 and the
  natural order of v8 equal the JAX _quant_head bit for bit, c and sv follow
  the JAX wrapper's order of multiplication, v8 comes in the kernel's layout
  padded with zeros to a multiple of the 128-key tile, views of the fused
  qkv rows give what contiguous copies give;
- a torch mirror of the pass's slot arithmetic (quant_heads.cu:v8_slot)
  against _v8_kernel_layout;
- a torch mirror of how the kernel packs p8 (attn_wgmma.cuh:attn_pack_p8,
  p8_bits): rint(127 p) as 127 p + 1.5 * 2^23 in fp32, read from the score
  accumulator's positions into mma.m16n8k32's 8-bit A fragments, times v8 in
  the kernel's slot order, is p8 . v in natural order;
- the plain version at its default key chunk (I8_KEY_CHUNK = 512) against
  the TPU kernel _kernel_i8 in interpret mode at its default bkv (512, no
  override), both modes, at n 640 and 1536 (several chunks, a partial last
  one) with kv_len inside the last chunk, on a chunk boundary and at n (the
  port's chunk was the kernel's 128-key tile before: 1.3e-2 relative off the
  JAX function in "qkpv");
- the plain version at ck = 128 against _kernel_i8 at bkv = 128, the same
  chunking, in both modes at the 128-key tile's edges (kv_len 1, 127-129,
  255, n; n 128-384; keys past kv_len at +-1e4): the arithmetic chunk by
  chunk. Tolerances, tests/test_torch_attn_int8.py's: "qkpv" 1 bf16 ulp of
  the output's scale and relative L2 1e-4 (exp2 of the two frameworks can
  flip a p8 at a tie); "qk" 2 ulps and 2e-3 (the port rounds p to bf16
  before p.v where the JAX kernel multiplies in fp32);
- a torch mirror of kernel 14's schedule (attn_wgmma.cuh, kI8): 128-key
  tiles in groups of four, a first sweep of S for the group's max, one
  alpha a group, S again with p, p8 and P.V tile by tile, the s32 P.V sum of
  the group, the partial last group and the tiles past kv_len skipped. On
  int8 operands its running max and its "qkpv" accumulator equal the plain
  version's at ck = 512 bit for bit (the row sum l differs in the order of
  its fp32 sum only), and with groups of one tile at ck = 128.
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_util import rel_err, t
from korean_f5_tts_tpu.ops import flash_prefix as jfp
from korean_f5_tts_tpu_torch.ops import KERNELS, flash_prefix, launch_counts, reset_launch_counts

TILE = 128


@pytest.fixture(autouse=True)
def _interpret_and_counts():
    old = jfp._INTERPRET
    jfp._INTERPRET = True
    reset_launch_counts()
    yield
    # on the CPU every wrapper takes its plain version: nothing launches
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    jfp._INTERPRET = old


def _bf16(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_the_kernel_tile_is_128():
    """The kernel's tile stays 128 keys; the chunk of the arithmetic is the
    JAX wrapper's default bkv, four tiles."""
    assert flash_prefix.I8_KEY_TILE == TILE
    bkv = inspect.signature(jfp.flash_prefix_attention_i8).parameters["bkv"].default
    assert flash_prefix.I8_KEY_CHUNK == bkv == 512 == 4 * TILE


@pytest.mark.parametrize("n", [1, 100, 128, 129, 300])
@pytest.mark.parametrize("views", [False, True])
def test_the_quantization_pass_plain_semantics(n, views):
    rng = np.random.default_rng(n)
    b, h, d = 2, 3, 64
    qkv = _bf16(rng, (b, n, 3 * h * d), 2.0)
    qkv[0, :, h * d:2 * h * d] *= 7.0  # heads of another scale
    if n > 5:
        qkv[1, 4, 5] = 300.0             # one outlier takes the head's range
    tq = t(qkv).to(torch.bfloat16)
    parts = flash_prefix.qkv_unpack(tq, h)
    if not views:
        parts = tuple(p.contiguous() for p in parts)
    q8, k8, v8, c, sv = flash_prefix.quantize_heads(*parts, True)
    n_pad = -(-n // TILE) * TILE
    H = b * h
    assert q8.shape == k8.shape == (H, n, d) and q8.dtype == k8.dtype == torch.int8
    assert v8.shape == (H, d, n_pad) and v8.dtype == torch.int8 and v8.is_contiguous()
    assert c.shape == sv.shape == (H,) and c.dtype == sv.dtype == torch.float32
    # the JAX pass, on the folded heads
    folded = [jnp.asarray(p.float().numpy().reshape(H, n, d)).astype(jnp.bfloat16) for p in parts]
    (jq8, aq), (jk8, ak), (jv8, av) = (jfp._quant_head(x) for x in folded)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(k8.numpy(), np.asarray(jk8))
    np.testing.assert_array_equal(flash_prefix._v8_natural_layout(v8, n).numpy(),
                                  np.asarray(jv8))
    assert flash_prefix._v8_natural_layout(v8, n_pad)[:, n:].abs().sum().item() == 0
    np.testing.assert_array_equal(c.numpy(), np.asarray(aq * ak * ((1.0 / 127.0 ** 2)
                                                                   * jfp.LOG2E / np.sqrt(d))))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(av * (1.0 / (127.0 * 127.0))))
    # "qk": v stays bf16 (folded), sv is zero
    q8b, k8b, vb, cb, svb = flash_prefix.quantize_heads(*parts, False)
    assert torch.equal(q8b, q8) and torch.equal(k8b, k8) and torch.equal(cb, c)
    assert vb.shape == (H, n, d) and vb.dtype == torch.bfloat16 and vb.is_contiguous()
    assert torch.equal(vb, parts[2].reshape(H, n, d)) and svb.abs().max().item() == 0


def test_the_quantization_pass_refuses_mismatched_shapes():
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one \\[b, h, n, d\\] shape"):
        flash_prefix.quantize_heads(q, q, q[:, :1])


def _v8_slot(r: int) -> int:
    """quant_heads.cu:v8_slot, line for line."""
    kk = r & 31
    return (r & ~31) + (kk & 16) + 4 * ((kk >> 1) & 3) + 2 * ((kk >> 3) & 1) + (kk & 1)


def test_the_pass_slot_arithmetic_is_the_kernel_layout():
    slots = [_v8_slot(r) for r in range(TILE)]
    assert sorted(slots) == list(range(TILE))  # a permutation of the chunk
    v8 = torch.randint(-127, 128, (1, TILE, 64), dtype=torch.int8)
    vk = flash_prefix._v8_kernel_layout(v8)
    for r in range(TILE):
        torch.testing.assert_close(vk[0, :, _v8_slot(r)], v8[0, r], rtol=0, atol=0)


def _p8_bits_low_byte(p: np.ndarray) -> np.ndarray:
    """attn_wgmma.cuh:p8_bits: 127 p + 1.5 * 2^23 in fp32, its low byte."""
    y = (p.astype(np.float32) * np.float32(127.0)).astype(np.float32) + np.float32(12582912.0)
    return (y.astype(np.float32).view(np.uint32) & 0xFF).astype(np.int64)


def _fragments(p8: np.ndarray) -> np.ndarray:
    """The [64, 128] s8 A operand the kernel hands wgmma, in fragment (slot)
    order: warp w, lane (g, t) holds the score accumulator's s[4j + e] (row
    16w + g + 8 (e >> 1), key 8j + 2t + (e & 1)); attn_pack_p8 puts, for the
    k32 step kk, s[16kk + 0, 1, 4, 5] into register 0 (row g, slots 32kk + 4t
    .. + 3), s[16kk + 2, 3, 6, 7] into register 1 (row g + 8), s[16kk + 8, 9,
    12, 13] into register 2 (row g, slots 32kk + 16 + 4t ..) and s[16kk + 10,
    11, 14, 15] into register 3 (row g + 8), mma.m16n8k32's A layout."""
    a = np.zeros((64, 128), np.int64)
    for w in range(4):
        for lane in range(32):
            g, tt = lane >> 2, lane & 3

            def s(i):
                return p8[16 * w + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * tt + (i & 1)]
            for kk in range(4):
                regs = [(0, (0, 1, 4, 5)), (8, (2, 3, 6, 7)), (0, (8, 9, 12, 13)),
                        (8, (10, 11, 14, 15))]
                for r_i, (dr, idx) in enumerate(regs):
                    col0 = 32 * kk + 4 * tt + (16 if r_i >= 2 else 0)
                    for byte, i in enumerate(idx):
                        a[16 * w + g + dr, col0 + byte] = s(16 * kk + i)
    return a


def test_p8_packs_into_the_fragments_against_the_v8_permutation():
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 1, (64, 128)).astype(np.float32)
    p[:, 100:] = 0.0            # masked keys
    p[:, 7] = 1.0               # the row max's own p
    p[0, :8] = (np.arange(8) + 0.5) / np.float32(127.0)  # ties of 127 p
    p8 = _p8_bits_low_byte(p)
    np.testing.assert_array_equal(p8, np.round(p.astype(np.float32) * np.float32(127.0)))
    v = rng.integers(-127, 128, (128, 64)).astype(np.int8)
    vk = flash_prefix._v8_kernel_layout(torch.from_numpy(v)[None])[0].numpy().astype(np.int64)
    got = _fragments(p8) @ vk.T     # what wgmma m64n64k32 sums over the slots
    np.testing.assert_array_equal(got, p8 @ v.astype(np.int64))


# (n, kv_lens, keys past kv_len at +-1e4)
EDGES = [
    (128, [1, 127, 128], False),
    (256, [129, 255], False),
    (256, [128, 256], True),
    (384, [384, 200], False),
    (384, [1, 383], True),
]


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
@pytest.mark.parametrize("n,lens,past", EDGES,
                         ids=[f"n{n}-kv{'_'.join(map(str, lens))}{'-past' if p else ''}"
                              for n, lens, p in EDGES])
def test_plain_at_the_kernel_tile_matches_the_tpu_kernel_at_bkv_128(n, lens, past, mode):
    rng = np.random.default_rng(n + sum(lens))
    b, h, d = len(lens), 2, 64
    q, k, v = (_bf16(rng, (b, h, n, d), s) for s in (1.5, 1.2, 0.8))
    if past:
        for i, length in enumerate(lens):
            for x in (k, v):
                x[i, :, length:] = 1e4 * np.sign(rng.standard_normal((h, n - length, d)))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    pv_i8 = mode == "qkpv"
    want = np.asarray(jfp.flash_prefix_attention_i8(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                                                    bq=128, bkv=TILE, pv_i8=pv_i8)
                      .astype(jnp.float32))
    lens_h = flash_prefix._fold_lens(torch.tensor(lens), b, h, "cpu")
    got = flash_prefix.flash_prefix_i8_reference(*(t(x).to(torch.bfloat16) for x in (q, k, v)),
                                                 lens_h, pv_i8=pv_i8, ck=TILE)
    assert got.dtype == torch.bfloat16 and got.shape == (b * h, n, d)
    _held_to_jax(got.reshape(b, h, n, d).float().numpy(), want, lens, pv_i8)


def _held_to_jax(got, want, lens, pv_i8):
    """The valid rows of [b, h, n, d] outputs within the module's bounds."""
    valid = np.concatenate([got[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    ref = np.concatenate([want[i, :, :L].reshape(-1) for i, L in enumerate(lens)])
    ulp = 2.0 ** -8 * max(1.0, np.abs(ref).max())  # one bf16 ulp at the output's scale
    diff = np.abs(valid - ref)
    if pv_i8:
        assert diff.max() <= ulp and rel_err(valid, ref) < 1e-4
    else:
        assert diff.max() <= 2 * ulp and rel_err(valid, ref) < 2e-3


# (n, kv_lens): chunks of 512 from key 0, the last one partial; kv_len inside
# the last chunk, on a chunk boundary, and at n
CHUNK_CASES = [(640, [600, 512, 640]), (1536, [1376, 1024, 1536])]


@pytest.mark.parametrize("mode", ["qkpv", "qk"])
@pytest.mark.parametrize("n,lens", CHUNK_CASES,
                         ids=[f"n{n}-kv{'_'.join(map(str, lens))}" for n, lens in CHUNK_CASES])
def test_plain_at_its_default_matches_the_tpu_kernel_at_its_default_bkv(n, lens, mode):
    """The function the JAX model runs (no F5_TTS_PREFIX_BKV): the port's
    default is the JAX default, through the public wrapper on CPU tensors."""
    rng = np.random.default_rng(n)
    b, h, d = len(lens), 2, 64
    # the scales of the equal-chunk test above, at which "qk"'s bound for
    # the port's bf16 p was set (unit-normal q, k flatten the softmax, and
    # the bf16 rounding of p then reads 2.4e-3 at n 640)
    q, k, v = (_bf16(rng, (b, h, n, d), s) for s in (1.5, 1.2, 0.8))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    pv_i8 = mode == "qkpv"
    want = np.asarray(jfp.flash_prefix_attention_i8(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                                                    bq=128, pv_i8=pv_i8).astype(jnp.float32))
    got = flash_prefix.flash_prefix_attention_i8(*(t(x).to(torch.bfloat16) for x in (q, k, v)),
                                                 torch.tensor(lens), pv_i8=pv_i8)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, d)
    _held_to_jax(got.float().numpy(), want, lens, pv_i8)


def kernel14_schedule(q8, k8, v, c, sv, kv_lens, pv_i8: bool, group: int = 4):
    """Kernel 14's loop (attn_wgmma.cuh, kI8) in torch: per head
    ceil(kv_len / 128) tiles of 128 keys (K, V rows past n zero, as TMA
    fills them), in groups of `group` tiles; sweep 1 takes the group's row
    max of the scaled, masked scores; one alpha a group rescales acc and l;
    sweep 2 recomputes S, p = exp2(s - m) tile by tile, adds p's row sums to
    l and p8 . v8 into one integer sum of the group ("qkpv", then acc +=
    float(sum) * sv), or bf16(p) . v into acc ("qk"). Returns (acc, l, m)
    as _i8_online does. v: int8 [H, n, d] (natural order) or bf16 / fp32.

    The heads run side by side, each tile a batched product: a tile or a
    group past a head's last valid key is all masked for that head, where
    max(m, -inf) = m, alpha = exp2(0) = 1 and p = 0 leave its acc, l and m
    as they were, the head-by-head loop that stops at its own last tile; a
    head with kv_len 0 keeps m = -inf, l = 0, acc = 0 (m enters the
    exponentials as 0 there, as _i8_online's m_safe). The integer products
    run in float64 (exact: |p8|, |v8| <= 127 over at most 512 keys a group,
    and |q8 . k8| <= 127^2 * d, far below 2^53)."""
    H, n, d = q8.shape
    lens = kv_lens.clamp(max=n).to(torch.int64)[:, None, None]
    n_tiles = -(-int(lens.max()) // TILE)
    pad = max(n_tiles * TILE - n, 0)
    k8p = torch.nn.functional.pad(k8.double(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.double() if pv_i8 else v.float(), (0, 0, 0, pad))
    qd = q8.double()
    cc = c[:, None, None]

    def scores(j):
        s = (qd @ k8p[:, j * TILE:(j + 1) * TILE].transpose(1, 2)).float() * cc
        col = torch.arange(j * TILE, (j + 1) * TILE)[None, None, :]
        return s.masked_fill(col >= lens, -math.inf)

    acc = torch.zeros((H, n, d))
    l = torch.zeros((H, n, 1))
    m = torch.full((H, n, 1), -math.inf)
    for j0 in range(0, n_tiles, group):
        tiles = range(j0, min(j0 + group, n_tiles))
        mx = torch.full((H, n, 1), -math.inf)
        for j in tiles:  # sweep 1
            mx = torch.maximum(mx, scores(j).amax(dim=-1, keepdim=True))
        m_new = torch.maximum(m, mx)
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_safe)
        m, l, acc = m_new, alpha * l, acc * alpha
        pv = torch.zeros((H, n, d), dtype=torch.float64)
        for j in tiles:  # sweep 2
            p = torch.exp2(scores(j) - m_safe)
            l = l + p.sum(dim=-1, keepdim=True)
            vt = vp[:, j * TILE:(j + 1) * TILE]
            if pv_i8:
                pv += torch.round(p * 127.0).double() @ vt
            else:
                pb = p if v.dtype == torch.float32 else p.to(torch.bfloat16).float()
                acc = acc + pb @ vt
        if pv_i8:
            acc = acc + pv.float() * sv[:, None, None]
    return acc, l, m


# (n, kv_lens): several chunks, a partial last one, kv_len 0, inside a chunk,
# on tile and chunk boundaries
SCHEDULE_CASES = [
    (640, [0, 1, 127, 128, 129, 511, 512, 513, 600, 640]),
    (1536, [1376, 1024, 1025, 1535, 1536, 200]),
    (300, [300, 257, 1]),
]


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("mode", ["qkpv", "qk"])
@pytest.mark.parametrize("n,lens", SCHEDULE_CASES,
                         ids=[f"n{n}" for n, _ in SCHEDULE_CASES])
def test_the_kernel_schedule_equals_the_plain_version_at_its_chunk(n, lens, mode, past):
    """Two sweeps of four tiles are the 512-key chunk: the running max and
    the "qkpv" accumulator to the bit. With keys past kv_len set to win every
    max (past), the masked tiles the kernel skips change nothing."""
    rng = np.random.default_rng(n + len(lens))
    H, d = len(lens), 64
    q8 = torch.from_numpy(rng.integers(-127, 128, (H, n, d)).astype(np.int8))
    k8 = torch.from_numpy(rng.integers(-127, 128, (H, n, d)).astype(np.int8))
    if past:  # keys past kv_len along q's mean direction: the largest scores
        for h, L in enumerate(lens):
            k8[h, L:] = (127 * q8[h].float().mean(0).sign()).to(torch.int8)
    pv_i8 = mode == "qkpv"
    if pv_i8:
        v = torch.from_numpy(rng.integers(-127, 128, (H, n, d)).astype(np.int8))
        sv = torch.from_numpy(rng.uniform(1e-5, 1e-4, H).astype(np.float32))
    else:
        v = t(rng.standard_normal((H, n, d)).astype(np.float32)).to(torch.bfloat16)
        sv = torch.zeros(H)
    c = torch.from_numpy(rng.uniform(2e-4, 6e-4, H).astype(np.float32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    for group, ck in ((4, flash_prefix.I8_KEY_CHUNK), (1, TILE)):
        acc, l, m = kernel14_schedule(q8, k8, v, c, sv, lens_t, pv_i8, group)
        acc_p, l_p, m_p = flash_prefix._i8_online(q8, k8, v, c, sv, lens_t, pv_i8, ck)
        assert torch.equal(m, m_p)
        if pv_i8:
            assert torch.equal(acc, acc_p)
        else:  # bf16 p . v summed tile by tile against one fp32 product a chunk
            torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, l_p, rtol=1e-6, atol=0)
    # the 512-key chunk is another function than the 128-key tile here
    assert not torch.equal(kernel14_schedule(q8, k8, v, c, sv, lens_t, pv_i8, 4)[0], acc)
