"""The port's paged attention kernels (rows 5, 6, 9 and 10 of the kernel
table) on CPU tensors — their plain versions — against the JAX package's
Pallas kernels run the way its own tests run them (``interpret=True``), on
the same numpy inputs; the ``ops`` front doors on both backends against
the JAX front doors, overflow recompute included; and the paged oracles.

Tolerances: TOL["float32"] for f32 inputs (same math, other summation
order: the plain versions walk one page per step as the TPU grid does);
TOL["bfloat16"] for bf16 inputs (bf16 rounds at other points in the two
frameworks). The CUDA kernels are held to these plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro.config import SoftmaxPhiConfig as JSoftmaxPhiConfig
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import chunk_attention as jca
from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core.plan import make_plan
from repro_torch.kernels import chunk_attention as tca
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import ref
from repro_torch.serving import kvquant as tkvquant

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``
    (rounded once on the JAX side, then carried over bit for bit)."""
    j = jnp.asarray(a, jnp.float32).astype(_JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(_TDT[dtype])
    return j, t


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, dtype: str = "float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def _pool_fixture(rng, *, b, hk, d, ps, nb, pages_per_row, dtype,
                  spare=3):
    """Pools of random pages (every row finite, so the plain versions'
    zero weights on masked keys stay exact zeros), shuffled tables with
    the sentinel NP past each row's pages; a row with 0 pages is an empty
    slot whose whole table is the sentinel."""
    num_pages = sum(pages_per_row) + spare
    kp = _pair(rng.normal(size=(num_pages, ps, hk, d)), dtype)
    vp = _pair(rng.normal(size=(num_pages, ps, hk, d)), dtype)
    perm = rng.permutation(num_pages)
    bt = np.full((b, nb), num_pages, np.int32)
    lo = 0
    for i, n in enumerate(pages_per_row):
        bt[i, :n] = perm[lo:lo + n]
        lo += n
    return kp, vp, _ints(bt)


# ---------------------------------------------------------------------------
# Rows 5-6: paged decode attention
# ---------------------------------------------------------------------------


# per page size: ragged lengths with a partial last page, a row ending on
# a page boundary, a one-page row, and an empty slot (sentinel table,
# length 1: the engine decodes free slots at new_len 1)
_DECODE = {16: ([53, 32, 7, 1], [4, 2, 1, 0], 4),
           64: ([150, 128, 7, 1], [3, 2, 1, 0], 3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_decode_matches_pallas(ps, dtype):
    lengths, pages, nb = _DECODE[ps]
    b, hq, hk, d = 4, 8, 2, 32
    rng = np.random.default_rng(ps)
    jq, tq = _pair(rng.normal(size=(b, hq, d)), dtype)
    (jk, tk), (jv, tv), (jbt, tbt) = _pool_fixture(
        rng, b=b, hk=hk, d=d, ps=ps, nb=nb, pages_per_row=pages,
        dtype=dtype)
    jl, tl = _ints(lengths)

    want, want_stat = jda.paged_decode_attention_unified_max(
        jq, jk, jv, jbt, jl, phi=0.25, interpret=True)
    got, stat = tda.paged_decode_attention_unified_max(tq, tk, tv, tbt, tl,
                                                       phi=0.25)
    _close(got, want, dtype)
    _close(stat, want_stat, dtype)
    want = jda.paged_decode_attention_sync(jq, jk, jv, jbt, jl,
                                           interpret=True)
    _close(tda.paged_decode_attention_sync(tq, tk, tv, tbt, tl), want, dtype)


# ---------------------------------------------------------------------------
# Rows 9-10: fused paged chunk attention
# ---------------------------------------------------------------------------


def _chunk_case(ps, c):
    """Lengths before the chunk: a partial last page, an empty prefix (the
    chunk is the whole sequence), a chunk that straddles a page boundary
    mid-page, and a spectator row (sentinel table, nothing before it)."""
    lengths = [37, 0, 3 * ps - c + 5, 0]
    pages = [-(-(n + c) // ps) for n in lengths[:3]] + [0]
    return lengths, pages, max(pages) + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64])
def test_paged_chunk_matches_pallas(ps, dtype):
    b, c, hq, hk, d = 4, 8, 8, 2, 32
    lengths, pages, nb = _chunk_case(ps, c)
    rng = np.random.default_rng(100 + ps)
    jq, tq = _pair(rng.normal(size=(b, c, hq, d)), dtype)
    (jk, tk), (jv, tv), (jbt, tbt) = _pool_fixture(
        rng, b=b, hk=hk, d=d, ps=ps, nb=nb, pages_per_row=pages,
        dtype=dtype)
    jl, tl = _ints(lengths)

    want, want_stat = jca.paged_chunk_attention_unified_max(
        jq, jk, jv, jbt, jl, phi=0.5, interpret=True)
    got, stat = tca.paged_chunk_attention_unified_max(tq, tk, tv, tbt, tl,
                                                      phi=0.5)
    assert got.shape == (b, c, hq, d) and stat.shape == (b, hk)
    _close(got, want, dtype)
    _close(stat, want_stat, dtype)
    want = jca.paged_chunk_attention_sync(jq, jk, jv, jbt, jl,
                                          interpret=True)
    _close(tca.paged_chunk_attention_sync(tq, tk, tv, tbt, tl), want, dtype)


@pytest.mark.parametrize("fn,shape", [
    (tda.paged_decode_attention_sync, (3, 4, 16)),
    (tca.paged_chunk_attention_sync, (3, 5, 4, 16)),
], ids=["decode", "chunk"])
def test_paged_sync_recompute_flag_selects_output(fn, shape):
    """``out``/``flag`` form: untouched when the flag is clear, replaced
    by the online-max result when it is set."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    (_, kp), (_, vp), (_, bt) = _pool_fixture(
        rng, b=3, hk=2, d=16, ps=8, nb=3, pages_per_row=[3, 1, 0],
        dtype="float32")
    lens = torch.tensor([19, 3, 1], dtype=torch.int32)
    sync = fn(q, kp, vp, bt, lens)
    prev = torch.full_like(sync, 7.0)
    assert torch.equal(fn(q, kp, vp, bt, lens, out=prev,
                          flag=torch.tensor(False)), prev)
    assert torch.equal(fn(q, kp, vp, bt, lens, out=prev,
                          flag=torch.tensor(True)), sync)
    with pytest.raises(ValueError, match="both"):
        fn(q, kp, vp, bt, lens, out=prev)


# ---------------------------------------------------------------------------
# Front doors (both backends, overflow recompute) and oracles
# ---------------------------------------------------------------------------


def _front_fixture(q_shape, q_scale, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=q_shape) * q_scale
    kv = _pool_fixture(rng, b=2, hk=2, d=32, ps=16, nb=4,
                       pages_per_row=[4, 2], dtype="float32")
    return _pair(q), kv


@pytest.mark.parametrize("q_scale", [1.0, 40.0], ids=["in_band", "overflow"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_attention_decode_paged_front_door_matches_jax(backend, q_scale):
    """``"cuda"`` runs the paged kernels (plain versions here) as JAX's
    ``"pallas"`` runs its own; ``"torch"`` gathers for the reference math
    as ``"xla"`` does. Logits 40x the unit scale cross φ's band, so both
    sides return the recomputed online-max result."""
    (jq, tq), ((jk, tk), (jv, tv), (jbt, tbt)) = _front_fixture(
        (2, 4, 32), q_scale, 5)
    jl, tl = _ints([61, 20])
    jplan = jmake_plan("pallas" if backend == "cuda" else "xla")
    want = jops.attention_decode_paged(jq, jk, jv, jbt, jl,
                                       phi_cfg=JSoftmaxPhiConfig(),
                                       plan=jplan)
    got = ops.attention_decode_paged(tq, tk, tv, tbt, tl,
                                     phi_cfg=SoftmaxPhiConfig(),
                                     plan=make_plan(backend))
    assert torch.isfinite(got).all()
    _close(got, want)
    if q_scale > 1:
        _, stat = tda.paged_decode_attention_unified_max(tq, tk, tv, tbt, tl)
        assert (stat > SoftmaxPhiConfig().band[1]).any()


@pytest.mark.parametrize("gather_chunk", ["fused", "dense"])
@pytest.mark.parametrize("q_scale", [1.0, 40.0], ids=["in_band", "overflow"])
@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_attention_chunk_paged_front_door_matches_jax(backend, q_scale,
                                                      gather_chunk):
    (jq, tq), ((jk, tk), (jv, tv), (jbt, tbt)) = _front_fixture(
        (2, 8, 4, 32), q_scale, 6)
    jl, tl = _ints([40, 9])
    jplan = jmake_plan("pallas" if backend == "cuda" else "xla",
                       gather_chunk=gather_chunk)
    want = jops.attention_chunk_paged(jq, jk, jv, jbt, jl,
                                      phi_cfg=JSoftmaxPhiConfig(),
                                      plan=jplan)
    got = ops.attention_chunk_paged(
        tq, tk, tv, tbt, tl, phi_cfg=SoftmaxPhiConfig(),
        plan=make_plan(backend, gather_chunk=gather_chunk))
    assert torch.isfinite(got).all()
    _close(got, want)


@pytest.mark.parametrize("oracle", ["gather", "decode", "decode_unified"])
def test_paged_oracles_match_jax(oracle):
    (jq, tq), ((jk, tk), (jv, tv), (jbt, tbt)) = _front_fixture(
        (2, 4, 32), 1.0, 7)
    jl, tl = _ints([50, 17])
    if oracle == "gather":
        _close(ref.gather_paged_kv(tk, tbt), jref.gather_paged_kv(jk, jbt))
    elif oracle == "decode":
        _close(ref.attention_decode_paged_ref(tq, tk, tv, tbt, tl),
               jref.attention_decode_paged_ref(jq, jk, jv, jbt, jl))
    else:
        out, stat = ref.attention_decode_paged_unified_max_ref(
            tq, tk, tv, tbt, tl, phi=0.5)
        jout, jstat = jref.attention_decode_paged_unified_max_ref(
            jq, jk, jv, jbt, jl, phi=0.5)
        _close(out, jout)
        _close(stat, jstat)


def test_paged_wrappers_check_inputs_and_count_only_launches():
    """The operand check a CUDA launch runs first rejects what the kernels
    do not take; CPU tensors run the plain versions without touching the
    build or the launch counters."""
    q = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    pool = torch.zeros(6, 16, 2, 32, dtype=torch.bfloat16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    tbt, tlens = tda.check_paged_inputs("t", q, pool, pool, bt, lens)
    assert tbt.dtype == tlens.dtype == torch.int32
    with pytest.raises(TypeError, match="bf16"):
        tda.check_paged_inputs("t", q.float(), pool, pool, bt, lens)
    with pytest.raises(ValueError, match="shapes"):
        tda.check_paged_inputs("t", q, pool, pool[:, :8], bt, lens)
    with pytest.raises(ValueError, match="head_dim 32/64/128"):
        tda.check_paged_inputs("t", q[..., :16], pool[..., :16],
                               pool[..., :16], bt, lens)
    with pytest.raises(ValueError, match="shapes"):
        tda.check_paged_inputs("t", q, pool, pool, bt[:1], lens)
    counters = (tda.paged_decode_attention_unified_max,
                tda.paged_decode_attention_sync,
                tca.paged_chunk_attention_unified_max,
                tca.paged_chunk_attention_sync)
    before = [f.launches for f in counters]
    tda.paged_decode_attention_unified_max(q, pool, pool, bt, lens)
    tda.paged_decode_attention_sync(q, pool, pool, bt, lens)
    qc = torch.zeros(2, 3, 4, 32, dtype=torch.bfloat16)
    tca.paged_chunk_attention_unified_max(qc, pool, pool, bt, lens)
    tca.paged_chunk_attention_sync(qc, pool, pool, bt, lens)
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# Rows 9-10 on the card: the split-KV emulation of the CUDA path
# ---------------------------------------------------------------------------


# positions before the chunk: empty, one, either side of and on the first
# split boundary (SPLIT_KEYS = 256), and a chunk reaching the table's end
_SPLIT_LENGTHS = [0, 1, 255, 256, 257, 960]


def _split_case(kind):
    """A C = 8 chunk for one row per length before it, over 64-row pages
    with NB = 16 (1,024 positions: 4 splits); f32 pools, or int8 / fp8
    codes with (NP, HK) steps quantized by the port and carried to JAX
    bit for bit. Returns the JAX and port operands and keyword args."""
    b, c, hq, hk, d, ps, nb = len(_SPLIT_LENGTHS), 8, 4, 2, 32, 64, 16
    rng = np.random.default_rng(300)
    pages = [-(-(n + c) // ps) for n in _SPLIT_LENGTHS]
    (jk, tk), (jv, tv), bt = _pool_fixture(
        rng, b=b, hk=hk, d=d, ps=ps, nb=nb, pages_per_row=pages,
        dtype="float32")
    jq, tq = _pair(rng.normal(size=(b, c, hq, d)))
    jkw, tkw = {}, {}
    if kind != "values":
        spec = tquant.INT8 if kind == "int8" else tquant.FP8
        (tk, ks), (tv, vs) = (tkvquant.quantize_pages(p, spec)
                              for p in (tk, tv))

        def carried(codes):
            raw = jnp.asarray(codes.view(torch.uint8).numpy())
            return raw.view(jnp.int8 if kind == "int8"
                            else jnp.float8_e4m3fn)

        jk, jv = carried(tk), carried(tv)
        jkw = dict(k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()))
        tkw = dict(k_scale=ks, v_scale=vs)
    return (jq, jk, jv, *bt[:1], _ints(_SPLIT_LENGTHS)[0], jkw), \
        (tq, tk, tv, bt[1], _ints(_SPLIT_LENGTHS)[1], tkw)


@pytest.mark.parametrize("kind", ["values", "int8", "fp8"])
def test_split_emulation_matches_plain_and_pallas(kind):
    """The split kernel and its combine, emulated on the CPU (keys cut at
    the fixed SPLIT_KEYS, partials folded with merge_unified / the
    guarded merge_lse), against the unsplit plain versions and the JAX
    Pallas kernels (interpret=True), both schemes: TOL["float32"] (f32
    q and values or dequantized codes; only summation order differs)."""
    (jq, jk, jv, jbt, jl, jkw), (tq, tk, tv, tbt, tl, tkw) = \
        _split_case(kind)
    got, stat = tca.paged_chunk_attention_split_plain(
        tq, tk, tv, tbt, tl, phi=0.5, **tkw)
    plain, plain_stat = tca.paged_chunk_attention_unified_max_plain(
        tq, tk, tv, tbt, tl, phi=0.5, **tkw)
    want, want_stat = jca.paged_chunk_attention_unified_max(
        jq, jk, jv, jbt, jl, phi=0.5, interpret=True, **jkw)
    for w, ws in ((plain, plain_stat), (want, want_stat)):
        _close(got, w)
        _close(stat, ws)
    got = tca.paged_chunk_attention_split_plain(
        tq, tk, tv, tbt, tl, unified_max=False, **tkw)
    assert torch.isfinite(got).all()
    _close(got, tca.paged_chunk_attention_sync_plain(tq, tk, tv, tbt, tl,
                                                     **tkw))
    _close(got, jca.paged_chunk_attention_sync(jq, jk, jv, jbt, jl,
                                               interpret=True, **jkw))


@pytest.mark.parametrize("unified_max", [True, False],
                         ids=["unified", "sync"])
def test_split_emulation_never_reads_past_the_last_valid_row(unified_max):
    """With chunk_lens, pool rows past each sequence's last valid position
    (a ragged chunk's unwritten rows) may hold NaN: the valid rows come
    out bitwise as on a clean pool and as without chunk_lens, and a table
    twice as wide (four more splits past every sequence) adds nothing."""
    _, (tq, tk, tv, tbt, tl, _) = _split_case("values")
    c, ps = tq.shape[1], tk.shape[1]
    clens = torch.tensor([8, 5, 1, 8, 3, 8], dtype=torch.int32)
    dirty = tk.clone(), tv.clone()
    for i, (n, m) in enumerate(zip(tl.tolist(), clens.tolist())):
        for pos in range(n + m, -(-(n + c) // ps) * ps):
            page = int(tbt[i, pos // ps])
            for pool in dirty:
                pool[page, pos % ps] = float("nan")
    wide = torch.cat([tbt, torch.full_like(tbt, tk.shape[0])], dim=1)

    def run(k, v, bt, **kw):
        res = tca.paged_chunk_attention_split_plain(
            tq, k, v, bt, tl, unified_max=unified_max, **kw)
        return res[0] if unified_max else res

    keep = torch.arange(c)[None, :] < clens[:, None]
    clean = run(tk, tv, tbt, chunk_lens=clens)[keep]
    assert torch.equal(run(*dirty, tbt, chunk_lens=clens)[keep], clean)
    assert torch.equal(run(tk, tv, tbt)[keep], clean)
    assert torch.equal(run(*dirty, wide, chunk_lens=clens)[keep], clean)


def test_chunk_launch_operands_and_alignment_checks():
    """What a CUDA launch allocates and refuses, on CPU tensors: NSPLIT =
    ceil(NB * PS / SPLIT_KEYS) and the f32 scratch shapes; chunk_lens of
    the wrong shape; q rows that are not 16-byte aligned (flash prefill's
    check too: the kernels copy rows with cp.async and never copy a
    tensor behind the caller's back)."""
    q = torch.zeros(2, 70, 4, 32, dtype=torch.bfloat16)
    pool = torch.zeros(6, 16, 2, 32, dtype=torch.bfloat16)
    bt = torch.zeros(2, 17, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    assert (tca.KERNEL_BLOCK_Q, tca.SPLIT_KEYS) == (64, 256)
    for unified, aux in ((True, (2, 4, 2, 2)), (False, (4, 70, 4))):
        *_, nsplit, (acc, den, aux_t) = tca._launch_operands(
            q, pool, pool, bt, lens, None, None, None, unified)
        assert nsplit == 2                      # 17 * 16 = 272 positions
        assert acc.shape == (4, 70, 4, 32) and den.shape == (4, 70, 4)
        assert aux_t.shape == aux and acc.dtype == torch.float32
    with pytest.raises(ValueError, match="chunk_lens"):
        tca._launch_operands(q, pool, pool, bt, lens, lens[:1], None, None,
                             True)
    skewed = torch.zeros(2, 70, 4, 40, dtype=torch.bfloat16)[..., 1:33]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tca._launch_operands(skewed, pool, pool, bt, lens, None, None, None,
                             True)
    from repro_torch.kernels import flash_prefill as tfp
    assert tfp.KERNEL_BLOCK_Q == 64
    kv = torch.zeros(2, 70, 2, 32, dtype=torch.bfloat16)
    tfp._check_inputs(q, kv, kv)
    qkv = torch.zeros(2, 70, 4 + 2 * 2, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfp._check_inputs(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
