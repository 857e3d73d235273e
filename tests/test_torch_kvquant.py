"""Quantized KV pages in the port (int8 / fp8 e4m3 codes with one f32 step
per (page, kv head)) against the JAX package, on the CPU.

* The write scatter (``serving/kvquant.py``): ``scatter_chunk_quantized``
  gives the JAX function's codes and steps bit for bit on ragged chunks,
  spectator rows, sentinel table entries, writes that span two pages, a
  reused page with a stale step, a write that raises a page's amax, and
  several partitions of the same tokens; the port's state is started
  from the JAX state carried across (``models/convert.py``). The JAX
  tests' properties hold for the port too, and ``quantize_pages`` /
  ``dequantize_pages`` are bitwise.
* Each quantized plain version (kernel-table rows 5, 6, 9, 10 and both
  stages of 11) within ``conftest.TOL`` of the JAX Pallas body run with
  the same steps (``interpret=True``).
* The ``ops`` front doors on ``"torch"``: quantized pools equal the same
  math on the pool-level dequantized view, and grouped equals ungrouped.
* The engine: the COW fork copies the scale rows; int8 / fp8 decode
  logits within ``logits_guard_tol`` of bf16; int8 greedy tokens equal
  across {gather, fused} x {sharing off, on} x {grouped off, on} and
  equal to the JAX engine's; the refusals, the plan's ``kv_dtype`` and
  the KV byte counters; the serve CLI's ``--kv-dtype``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TOL
from repro import configs as jconfigs
from repro.core.plan import make_plan as jmake_plan
from repro.kernels import chunk_attention as jca
from repro.kernels import decode_attention as jda
from repro.kernels import group_attention as jga
from repro.kernels import quant as jq
from repro.models.api import get_model as jget_model
from repro.serving import kvquant as jkv
from repro.serving.engine import Engine as JEngine
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import SoftmaxPhiConfig
from repro_torch.core.plan import make_plan
from repro_torch.kernels import chunk_attention as tca
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import group_attention as tga
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant as tq
from repro_torch.models.api import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.kvlayout import PagedLayout
from repro_torch.models.layers import LayerCtx
from repro_torch.serving import kvquant as tkv
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import SamplingParams

SPECS = [(jq.INT8, tq.INT8), (jq.FP8, tq.FP8)]
IDS = ["int8", "fp8"]
ARCH = "qwen2-0.5b"
F32 = dict(param_dtype="float32", activation_dtype="float32")


def _t(a) -> torch.Tensor:
    """A JAX (or numpy) array on the CPU as a torch tensor, bit for bit."""
    return params_from_numpy({"a": jax.device_get(a)}, device="cpu")["a"]


def _bits(a) -> np.ndarray:
    """Raw bytes of a torch tensor or a JAX / numpy array."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(jax.device_get(a))).view(np.uint8)


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(_bits(t), _bits(j))


# ---------------------------------------------------------------------------
# The scatter, bitwise against the JAX package
# ---------------------------------------------------------------------------

_PS, _HK, _D, _NP = 8, 2, 32, 12


def _scatter_both(specs, state, new, bt, lengths, chunk_lens):
    """One scatter through the JAX function and the port's, from the same
    state (the port's carried across from the JAX arrays); asserts the
    codes and steps bitwise and returns the JAX state."""
    js, ts = specs
    codes, steps = state
    new = np.array(new, np.float32)
    ints = [np.asarray(a, np.int32) for a in (bt, lengths, chunk_lens)]
    want = jkv.scatter_chunk_quantized(codes, steps, jnp.asarray(new),
                                       *map(jnp.asarray, ints), js)
    tc, tsteps = _t(codes).clone(), _t(steps).clone()
    got = tkv.scatter_chunk_quantized(tc, tsteps, torch.from_numpy(new),
                                      *map(torch.from_numpy, ints), ts)
    assert got[0] is tc and got[1] is tsteps          # in place
    assert tc.dtype == ts.code_dtype
    assert _same(tsteps, want[1]), "steps differ from the JAX package's"
    assert _same(tc, want[0]), "codes differ from the JAX package's"
    return want


def _fresh(js):
    return (jnp.zeros((_NP, _PS, _HK, _D), js.code_dtype),
            jnp.zeros((_NP, _HK), jnp.float32))


def _dirty(js, rng):
    """A pool a previous tenant filled: loud codes and steps everywhere."""
    x = jnp.asarray(rng.normal(size=(_NP, _PS, _HK, _D)) * 30.0,
                    jnp.float32)
    return jkv.quantize_pages(x, js)


def _content(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_scatter_ragged_spectators_sentinels_bitwise(specs):
    """Three rows in one chunk: one spans two pages, one is a spectator
    (chunk_lens 0), one writes into a sentinel table entry (dropped);
    then a decode-shaped append of one token per row."""
    rng = np.random.default_rng(0)
    bt = np.array([[3, 7, 1, _NP], [_NP] * 4, [5, _NP, _NP, _NP]], np.int32)
    state = _scatter_both(specs, _fresh(specs[0]),
                          _content(rng, 3, 8, _HK, _D), bt, [5, 0, 6],
                          [8, 0, 5])
    _scatter_both(specs, state, _content(rng, 3, 1, _HK, _D), bt,
                  [13, 0, 11], [1, 0, 1])


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_scatter_reused_page_with_stale_step_bitwise(specs):
    """A pool left full by an earlier tenant: writes that cover a page's
    position 0 reset its step, one that starts mid-page rescales the
    stale codes."""
    rng = np.random.default_rng(1)
    bt = np.array([[2, 9, 4, 0], [6, 11, 8, 10]], np.int32)
    state = _scatter_both(specs, _dirty(specs[0], rng),
                          _content(rng, 2, 8, _HK, _D), bt, [0, 3],
                          [8, 8])
    _scatter_both(specs, state, _content(rng, 2, 8, _HK, _D), bt, [8, 11],
                  [7, 8])


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_scatter_rescale_on_raised_amax_bitwise(specs):
    """Quiet tokens, then a loud one into the same page (every earlier
    code re-expressed under the raised step), then a quiet one again
    (ratio 1: the page's codes stay put)."""
    rng = np.random.default_rng(2)
    bt = np.array([[4, 1, 0, 0]], np.int32)
    state = _scatter_both(specs, _fresh(specs[0]),
                          _content(rng, 1, 5, _HK, _D), bt, [0], [5])
    state = _scatter_both(specs, state, _content(rng, 1, 2, _HK, _D,
                                                 scale=40.0), bt, [5], [2])
    _scatter_both(specs, state, _content(rng, 1, 1, _HK, _D), bt, [7], [1])


@pytest.mark.parametrize("parts", [[8, 8, 4], [20], [3, 5, 7, 5],
                                   [1] * 6 + [14]],
                         ids=["aligned", "one_shot", "split", "tokens"])
@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_scatter_partitions_bitwise(specs, parts):
    """The same 20 tokens written in several chunk partitions, each chunk
    bitwise the JAX package's; bf16 inputs (the serving path's)."""
    rng = np.random.default_rng(3)
    content = np.asarray(jnp.asarray(_content(rng, 20, _HK, _D)).astype(
        jnp.bfloat16).astype(jnp.float32))
    bt = np.array([[6, 0, 9, 2]], np.int32)
    state, length = _fresh(specs[0]), 0
    for c in parts:
        state = _scatter_both(specs, state,
                              content[None, length:length + c], bt,
                              [length], [c])
        length += c


def _port_seq(ts, content, bt, parts, state=None, num_pages=_NP,
              page_size=_PS):
    """The port's scatter of ``content`` (T, HK, D) over successive
    chunks of one row, into ``state`` or a fresh pool."""
    hk, d = content.shape[1:]
    codes, steps = state if state is not None else (
        torch.zeros((num_pages, page_size, hk, d), dtype=ts.code_dtype),
        torch.zeros((num_pages, hk)))
    length = 0
    for c in parts:
        tkv.scatter_chunk_quantized(
            codes, steps, torch.from_numpy(content[None, length:length + c]),
            torch.tensor(bt, dtype=torch.int32),
            torch.tensor([length], dtype=torch.int32),
            torch.tensor([c], dtype=torch.int32), ts)
        length += c
    return codes, steps


def _eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.uint8) if a.element_size() == 1 else a,
                       b.view(torch.uint8) if b.element_size() == 1 else b)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_scatter_properties(specs):
    """The JAX tests' properties, on the port, at their sizes (4-row
    pages): partition invariance (steps always; codes where no page is
    split, and within two round-trip bounds where one is), page-aligned
    writes equal one-shot ``quantize_pages``, no stale-step inheritance,
    and lanes that do not land write nothing."""
    _, ts = specs
    shape = dict(num_pages=6, page_size=4)
    content = np.random.default_rng(1).normal(size=(10, 2, 4)).astype(
        np.float32)
    bt = [[2, 0, 5, 3]]
    aligned = _port_seq(ts, content, bt, [4, 4, 2], **shape)
    one = _port_seq(ts, content, bt, [10], **shape)
    split = _port_seq(ts, content, bt, [3, 3, 3, 1], **shape)
    assert _eq(aligned[0], one[0]) and _eq(aligned[1], one[1])
    assert _eq(split[1], one[1])
    da = tkv.dequantize_pages(*aligned)
    bound = tq.roundtrip_bound(da, aligned[1][:, None], ts)
    assert bool(((tkv.dequantize_pages(*split) - da).abs()
                 <= 2.0 * bound + 1e-30).all())
    rng = np.random.default_rng(2)
    eight = rng.normal(size=(8, 2, 4)).astype(np.float32)
    codes, steps = _port_seq(ts, eight, [[4, 1, 0, 0]], [4, 4], **shape)
    want = tkv.quantize_pages(torch.from_numpy(eight).reshape(2, 4, 2, 4),
                              ts)
    pages = torch.tensor([4, 1])
    assert _eq(codes[pages], want[0]) and _eq(steps[pages], want[1])
    # a page freed by a loud tenant and written again from its position 0
    # ends bitwise as in a fresh pool
    rng = np.random.default_rng(3)
    big = (rng.normal(size=(4, 2, 4)) * 1e3).astype(np.float32)
    small = rng.normal(size=(4, 2, 4)).astype(np.float32)
    dirty = _port_seq(ts, big, [[2, 0, 0, 0]], [4], **shape)
    reused = _port_seq(ts, small, [[2, 0, 0, 0]], [4], state=dirty)
    fresh = _port_seq(ts, small, [[2, 0, 0, 0]], [4], **shape)
    assert _eq(reused[0][2], fresh[0][2]) and _eq(reused[1][2], fresh[1][2])
    # no lane lands (a spectator row, a row on sentinel pages): every bit
    # stays
    before = (reused[0].clone(), reused[1].clone())
    tkv.scatter_chunk_quantized(
        reused[0], reused[1], torch.ones((2, 4, 2, 4)),
        torch.tensor([[1, 0, 0, 0], [6] * 4], dtype=torch.int32),
        torch.tensor([0, 3], dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32), ts)
    assert _eq(reused[0], before[0]) and _eq(reused[1], before[1])
    with pytest.raises(TypeError):
        tkv.scatter_chunk_quantized(
            reused[0], reused[1], torch.ones((1, 1, 2, 4)),
            torch.tensor([[1, 0, 0, 0]], dtype=torch.int32),
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32),
            tq.FP8 if ts.is_int else tq.INT8)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantize_dequantize_pages_bitwise(specs):
    js, ts = specs
    rng = np.random.default_rng(5)
    x = _content(rng, 3, _PS, _HK, _D)
    x[1] = 0.0                               # an all-zero page: step 0
    x[2, 0, 1, 3] = 500.0                    # one loud element
    jc, jst = jkv.quantize_pages(jnp.asarray(x), js)
    tc, tst = tkv.quantize_pages(torch.from_numpy(x), ts)
    assert _same(tc, jc) and _same(tst, jst)
    assert _same(tkv.dequantize_pages(tc, tst),
                 jkv.dequantize_pages(jc, jst))
    assert _same(ref.dequantize_pool_ref(tc, tst),
                 jnp.asarray(jc).astype(jnp.float32)
                 * jst[:, None, :, None])


# ---------------------------------------------------------------------------
# The quantized plain versions against the JAX Pallas bodies
# ---------------------------------------------------------------------------


def _qpools(specs, rng, *, b, hk, d, ps, pages_per_row, nb, spare=3):
    """A quantized pool (codes + steps, JAX and port) of random pages with
    shuffled tables, the sentinel NP past each row's pages."""
    js, _ = specs
    num_pages = sum(pages_per_row) + spare
    out = []
    for _ in range(2):
        c, s = jkv.quantize_pages(jnp.asarray(
            _content(rng, num_pages, ps, hk, d)), js)
        out.append(((c, s), (_t(c), _t(s))))
    perm = rng.permutation(num_pages)
    bt = np.full((b, nb), num_pages, np.int32)
    lo = 0
    for i, n in enumerate(pages_per_row):
        bt[i, :n] = perm[lo:lo + n]
        lo += n
    return out, (jnp.asarray(bt), torch.from_numpy(bt))


def _q(rng, *shape):
    j = jnp.asarray(_content(rng, *shape)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want, dtype):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantized_paged_decode_matches_pallas(specs):
    """Rows 5 and 6 with steps."""
    rng = np.random.default_rng(10)
    b, hq, hk, d, ps = 4, 8, 2, 32, 16
    pools, (jbt, tbt) = _qpools(specs, rng, b=b, hk=hk, d=d, ps=ps,
                                pages_per_row=[4, 2, 1, 0], nb=4)
    (jk, tk), (jv, tv) = pools
    jqq, tqq = _q(rng, b, hq, d)
    jl, tl = _ints([53, 32, 7, 1])
    jkw = dict(k_scale=jk[1], v_scale=jv[1], interpret=True)
    tkw = dict(k_scale=tk[1], v_scale=tv[1])
    want, want_stat = jda.paged_decode_attention_unified_max(
        jqq, jk[0], jv[0], jbt, jl, phi=0.25, **jkw)
    got, stat = tda.paged_decode_attention_unified_max(
        tqq, tk[0], tv[0], tbt, tl, phi=0.25, **tkw)
    _close(got, want, "bfloat16")
    _close(stat, want_stat, "float32")
    want = jda.paged_decode_attention_sync(jqq, jk[0], jv[0], jbt, jl, **jkw)
    _close(tda.paged_decode_attention_sync(tqq, tk[0], tv[0], tbt, tl, **tkw),
           want, "bfloat16")


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantized_paged_chunk_matches_pallas(specs):
    """Rows 9 and 10 with steps."""
    rng = np.random.default_rng(11)
    b, c, hq, hk, d, ps = 4, 8, 8, 2, 32, 16
    lengths = [37, 0, 3 * ps - c + 5, 0]
    pages = [-(-(n + c) // ps) for n in lengths[:3]] + [0]
    pools, (jbt, tbt) = _qpools(specs, rng, b=b, hk=hk, d=d, ps=ps,
                                pages_per_row=pages, nb=max(pages) + 1)
    (jk, tk), (jv, tv) = pools
    jqq, tqq = _q(rng, b, c, hq, d)
    jl, tl = _ints(lengths)
    jkw = dict(k_scale=jk[1], v_scale=jv[1], interpret=True)
    tkw = dict(k_scale=tk[1], v_scale=tv[1])
    want, want_stat = jca.paged_chunk_attention_unified_max(
        jqq, jk[0], jv[0], jbt, jl, phi=0.5, **jkw)
    got, stat = tca.paged_chunk_attention_unified_max(
        tqq, tk[0], tv[0], tbt, tl, phi=0.5, **tkw)
    _close(got, want, "bfloat16")
    _close(stat, want_stat, "float32")
    want = jca.paged_chunk_attention_sync(jqq, jk[0], jv[0], jbt, jl, **jkw)
    _close(tca.paged_chunk_attention_sync(tqq, tk[0], tv[0], tbt, tl, **tkw),
           want, "bfloat16")


def _group_case(specs, seed):
    """Rows 0 and 2 share row 0's first two pages (a 32-token prefix) as
    one group; row 1 is solo (the JAX package's grouped fixture)."""
    rng = np.random.default_rng(seed)
    pools, (jbt, _) = _qpools(specs, rng, b=3, hk=2, d=64, ps=16,
                              pages_per_row=[7, 3, 5], nb=8)
    bt = np.asarray(jbt).copy()
    bt[2, :2] = bt[0, :2]
    arrays = (bt[:1, :2].copy(), [2], [32], [2], [[0, 2]], [0, 1, 0],
              [0, 0, 1], [32, 0, 32])
    jgroups = jga.DecodeGroups(*(jnp.asarray(np.asarray(a, np.int32))
                                 for a in arrays))
    tgroups = tga.DecodeGroups(*(torch.tensor(np.asarray(a, np.int32))
                                 for a in arrays))
    jqq, tqq = _q(rng, 3, 8, 64)
    lengths = _ints([100, 37, 72])
    return pools, _ints(bt), (jgroups, tgroups), (jqq, tqq), lengths


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantized_grouped_decode_matches_pallas(specs):
    """Row 11, both stages, with steps: the port's two plain stages
    against the JAX two-stage kernel (out; the JAX stat is group-wide),
    and the port's stat against the ungrouped plain version's."""
    ((jk, tk), (jv, tv)), (jbt, tbt), (jg, tg), (jqq, tqq), (jl, tl) = \
        _group_case(specs, 12)
    want, _ = jga.grouped_paged_decode_attention_unified_max(
        jqq, jk[0], jv[0], jbt, jl, jg, phi=0.0, k_scale=jk[1],
        v_scale=jv[1], interpret=True)
    tkw = dict(phi=0.0, k_scale=tk[1], v_scale=tv[1])
    parts = tga.group_prefix_partials(tqq, tk[0], tv[0], tg, **tkw)
    got, stat = tga.group_tail_merge(tqq, tk[0], tv[0], tbt, tl, tg, *parts,
                                     **tkw)
    _close(got, want, "bfloat16")
    _, flat_stat = tda.paged_decode_attention_unified_max(
        tqq, tk[0], tv[0], tbt, tl, **tkw)
    _close(stat, flat_stat, "float32")


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_quantized_ops_torch_equal_dequantized_view(specs):
    """The ``"torch"`` front doors: a quantized pool is bitwise the same
    math on ``ref.dequantize_pool_ref``'s view, grouped bitwise
    ungrouped; the ``"cuda"`` plan on CPU tensors (the plain versions)
    stays within TOL of it."""
    ((_, (kc, ks)), (_, (vc, vs))), (_, bt), (_, groups), (_, q), \
        (_, lens) = _group_case(specs, 13)
    kd, vd = ref.dequantize_pool_ref(kc, ks), ref.dequantize_pool_ref(vc, vs)
    phi = SoftmaxPhiConfig(enabled=True, phi=0.0)
    torch_plan = make_plan("torch")
    qkw = dict(k_scale=ks, v_scale=vs, phi_cfg=phi)
    got = ops.attention_decode_paged(q, kc, vc, bt, lens, plan=torch_plan,
                                     **qkw)
    want = ops.attention_decode_paged(q, kd, vd, bt, lens, plan=torch_plan,
                                      phi_cfg=phi)
    assert torch.equal(got, want)
    grouped = ops.attention_decode_paged(q, kc, vc, bt, lens,
                                         plan=torch_plan, groups=groups,
                                         **qkw)
    assert torch.equal(grouped, got)
    cuda = ops.attention_decode_paged(q, kc, vc, bt, lens,
                                      plan=make_plan("cuda"), groups=groups,
                                      **qkw)
    _close(cuda, got, "bfloat16")
    qc = q[:, None].expand(3, 4, 8, 64).contiguous()
    before = torch.tensor([30, 10, 40], dtype=torch.int32)
    got = ops.attention_chunk_paged(qc, kc, vc, bt, before, plan=torch_plan,
                                    **qkw)
    want = ops.attention_chunk_paged(qc, kd, vd, bt, before, plan=torch_plan,
                                     phi_cfg=phi)
    assert torch.equal(got, want)
    fused = ops.attention_chunk_paged(qc, kc, vc, bt, before,
                                      plan=make_plan("cuda"), **qkw)
    _close(fused, got, "bfloat16")


def test_quantized_wrappers_check_steps():
    """Steps are the only signal: codes without steps and steps beside bf16
    pools are refused before any launch; the plain versions count no
    launch."""
    q = torch.zeros(2, 4, 32, dtype=torch.bfloat16)
    codes = torch.zeros(6, 16, 2, 32, dtype=torch.int8)
    steps = torch.zeros(6, 2)
    bf = torch.zeros(6, 16, 2, 32, dtype=torch.bfloat16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    tda.check_paged_inputs("t", q, codes, codes, bt, lens, steps, steps)
    assert tda.code_flag(codes, steps) == 0
    assert tda.code_flag(codes.view(torch.float8_e4m3fn), steps) == 1
    assert tda.code_flag(bf, None) is None
    with pytest.raises(TypeError, match="bf16 pools"):
        tda.check_paged_inputs("t", q, codes, codes, bt, lens)
    with pytest.raises(TypeError, match="code pools"):
        tda.check_paged_inputs("t", q, bf, bf, bt, lens, steps, steps)
    with pytest.raises(ValueError, match="both"):
        tda.check_paged_inputs("t", q, codes, codes, bt, lens, steps, None)
    with pytest.raises(ValueError, match="steps"):
        tda.check_paged_inputs("t", q, codes, codes, bt, lens, steps[:4],
                               steps[:4])
    wide = torch.zeros(6, 16, 2, 40, dtype=torch.int8)[..., :32]
    with pytest.raises(ValueError, match="aligned"):
        tda.check_paged_inputs("t", q, wide, wide, bt, lens, steps, steps)
    counters = [c for c in ops.LAUNCH_COUNTERS
                if c.__name__.endswith("_quant")]
    assert {c.__name__ for c in counters} >= {
        "paged_decode_attention_unified_max_quant",
        "paged_decode_attention_sync_quant",
        "paged_chunk_attention_unified_max_quant",
        "paged_chunk_attention_sync_quant", "group_prefix_partials_quant",
        "group_tail_merge_quant"}
    before = [c.launches for c in counters]
    tda.paged_decode_attention_unified_max(q, codes, codes, bt, lens,
                                           k_scale=steps, v_scale=steps)
    assert [c.launches for c in counters] == before


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

_PAGE = 16


@pytest.fixture(scope="module")
def port_model():
    cfg = tconfigs.smoke(tconfigs.get(ARCH))
    api = tget_model(cfg)
    return cfg, api, api.init_params(torch.Generator().manual_seed(0),
                                     device="cpu")


def _engine(cfg, params, kv_dtype, *, mode="dense", sharing=False,
            backend="cuda", decode_group="off", **kw):
    plan = make_plan(backend, gather_chunk=mode, fused_threshold=1,
                     decode_group=decode_group)
    return Engine(cfg, params, num_slots=3, max_seq=128, cache_kind="paged",
                  page_size=_PAGE, prefill_chunk=_PAGE, plan=plan,
                  kv_dtype=kv_dtype, prefix_sharing=sharing, device="cpu",
                  **kw)


def _prompts(vocab, sharing, seed=11):
    rng = np.random.default_rng(seed)
    if sharing:
        head = rng.integers(1, vocab, size=32).astype(np.int32)
        return [np.concatenate([head, rng.integers(
            1, vocab, size=_PAGE).astype(np.int32)]) for _ in range(3)]
    return [rng.integers(1, vocab, size=48).astype(np.int32)
            for _ in range(3)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_cow_fork_copies_scale_rows(port_model, specs):
    """The engine's page copy moves every cache leaf: the forked page gets
    its own copy of the scale rows, and a later write into the fork
    leaves the source page's codes and step alone."""
    cfg, _, params = port_model
    _, ts = specs
    eng = _engine(cfg, params, ts.name)
    assert set(eng.cache) == {"k", "v", "k_scale", "v_scale"}
    rng = np.random.default_rng(8)
    for name in ("k", "v"):
        codes, steps = eng.cache[name], eng.cache[name + "_scale"]
        for layer in range(codes.shape[0]):
            tkv.scatter_chunk_quantized(
                codes[layer], steps[layer],
                torch.from_numpy(_content(rng, 1, 4, *codes.shape[-2:])),
                torch.tensor([[1, 0]], dtype=torch.int32),
                torch.tensor([0], dtype=torch.int32),
                torch.tensor([4], dtype=torch.int32), ts)
    src, dst = 1, 3
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng._copy_page(src, dst)
    assert eng.stats.cow_forks == 1
    for name, t in eng.cache.items():
        assert _eq(t[:, dst], before[name][:, src]), name
    codes, steps = eng.cache["k"][0], eng.cache["k_scale"][0]
    tkv.scatter_chunk_quantized(
        codes, steps, torch.from_numpy(_content(rng, 1, 2, *codes.shape[-2:],
                                                scale=50.0)),
        torch.tensor([[dst, 0]], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32),
        torch.tensor([2], dtype=torch.int32), ts)
    assert _eq(codes[src], before["k"][0, src])
    assert _eq(steps[src], before["k_scale"][0, src])
    assert not torch.equal(steps[dst], before["k_scale"][0, src])


def _probe(eng, api, prompts):
    """Admit and prefill only (the written KV is exactly the prompts),
    then one decode step's logits through the engine's own plan."""
    sp = SamplingParams(max_new_tokens=4)
    for p in prompts:
        eng.submit(p.copy(), sp)
    eng._admit()
    assert len(eng.by_slot) == len(prompts)
    rows = sorted(eng.by_slot)
    toks = torch.arange(1, eng.num_slots + 1, dtype=torch.int32)
    logits, _ = api.decode_step(
        LayerCtx(cfg=eng.cfg, plan=eng.plan), eng.params, toks, eng.cache,
        eng.slots.lengths_device(eng.device),
        block_tables=eng.slots.block_tables(eng.device))
    return logits[rows, :eng.cfg.vocab_size].float()


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("sharing", [False, True], ids=["private", "shared"])
@pytest.mark.parametrize("mode", ["dense", "fused"])
@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_decode_logits_within_guard(port_model, specs, mode, sharing,
                                    backend):
    """int8 and fp8 decode logits stay within the JAX package's guard,
    ``logits_guard_tol(spec) x max(|logits|, 1)``, of bf16, under the
    default ``"cuda"`` plan (the kernels' plain versions on the CPU) and
    the ``"torch"`` plan."""
    cfg, api, params = port_model
    _, ts = specs
    prompts = _prompts(cfg.vocab_size, sharing)
    out = {kd: _probe(_engine(cfg, params, kd, mode=mode, sharing=sharing,
                              backend=backend), api, prompts)
           for kd in ("bf16", ts.name)}
    atol = tq.logits_guard_tol(ts) * max(out["bf16"].abs().max().item(), 1.0)
    err = (out[ts.name] - out["bf16"]).abs().max().item()
    assert err <= atol, (err, atol)
    assert err > 0.0                    # the codes really were read


def test_int8_greedy_identical_across_paged_modes(port_model):
    """On ``"torch"`` the codes are a pure function of the write history,
    so int8 greedy tokens are identical across {gather, fused} x {sharing
    off, on} x {grouped off, on}; grouped decode really grouped rows."""
    cfg, _, params = port_model
    prompts = _prompts(cfg.vocab_size, sharing=True)
    sp = SamplingParams(max_new_tokens=5)

    def run(**kw):
        eng = _engine(cfg, params, "int8", backend="torch", **kw)
        out = eng.run([(p.copy(), sp) for p in prompts])
        if kw.get("decode_group") == "grouped":
            assert eng.stats.grouped_requests > 0
        return [out[k] for k in sorted(out)]

    base = run(mode="dense")
    assert run(mode="fused") == base
    for mode in ("dense", "fused"):
        assert run(mode=mode, sharing=True) == base
        assert run(mode=mode, sharing=True, decode_group="grouped") == base


@pytest.fixture(scope="module")
def ref_model():
    jcfg = dataclasses.replace(jconfigs.smoke(jconfigs.get(ARCH)), **F32)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tconfigs.smoke(tconfigs.get(ARCH)), **F32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams),
                                                  device="cpu")


@pytest.mark.parametrize("mode,sharing", [("dense", False), ("fused", True)],
                         ids=["gather", "fused_shared"])
def test_int8_engine_matches_reference(ref_model, mode, sharing):
    """int8 greedy tokens equal the JAX engine's on the same params and
    plan knobs (5 requests through 2 slots: waves, page reuse, a shared
    header); so do the KV byte counters."""
    jcfg, jparams, tcfg, tparams = ref_model
    rng = np.random.default_rng(11)
    header = rng.integers(1, 500, size=32).astype(np.int32)
    prompts = [np.concatenate([header, rng.integers(1, 500, size=n).astype(
        np.int32)]) for n in (3, 19, 8, 27, 12)]
    budgets = [6, 3, 9, 1, 5]
    kw = dict(num_slots=2, max_seq=128, page_size=16, prefill_chunk=16,
              cache_kind="paged", prefix_sharing=sharing, kv_dtype="int8")
    jeng = JEngine(jcfg, jparams, plan=jmake_plan(
        gather_chunk=mode, fused_threshold=1), **kw)
    want = jeng.run([(p, JSamplingParams(max_new_tokens=m))
                     for p, m in zip(prompts, budgets)])
    teng = Engine(tcfg, tparams, plan=make_plan(
        "cuda", gather_chunk=mode, fused_threshold=1, fused_ffn=False),
        device="cpu", **kw)
    got = teng.run([(p, SamplingParams(max_new_tokens=m))
                    for p, m in zip(prompts, budgets)])
    assert got == want
    assert teng.cache["k"].dtype == torch.int8
    for field in ("kv_page_bytes", "kv_bytes_decode_read", "cow_forks",
                  "shared_prefix_pages"):
        assert getattr(teng.stats, field) == getattr(jeng.stats, field), field


def test_engine_kv_dtype_refusals_plan_and_counters(port_model):
    """The reference's precedence and errors, the plan's ``kv_dtype``
    adopted by paged engines only, and the byte counters: an int8 page
    costs at least 1.9x fewer bytes, and every decode tick adds the
    resident pages' bytes."""
    cfg, _, params = port_model
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, params, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(cfg, params, "int4")
    plan = make_plan("cuda", kv_dtype="int8")
    assert plan.paged.kv_dtype == "int8"
    eng = Engine(cfg, params, cache_kind="paged", page_size=_PAGE,
                 prefill_chunk=_PAGE, max_seq=128, num_slots=2, plan=plan,
                 device="cpu")
    assert eng.kv_dtype == "int8" and eng.cache["k"].dtype == torch.int8
    assert Engine(cfg, params, plan=plan, device="cpu").kv_dtype == "bf16"
    bf16 = _engine(cfg, params, "bf16")
    assert bf16.cache["k"].dtype == torch.bfloat16
    assert "k_scale" not in bf16.cache
    assert bf16.stats.kv_page_bytes >= 1.9 * eng.stats.kv_page_bytes
    sp = SamplingParams(max_new_tokens=4)
    for p in _prompts(cfg.vocab_size, False)[:2]:
        eng.submit(p, sp)
    reads = []
    while eng.waiting or eng.by_slot:
        eng.step()
        reads.append(eng.stats.kv_bytes_decode_read)
    assert all(b > a for a, b in zip([0] + reads, reads))
    assert reads[-1] % eng.stats.kv_page_bytes == 0


def test_serve_cli_kv_dtype(capsys):
    """``--kv-dtype int8`` serves on the CPU and prints the ``kv=``
    segment; ``--kv-dtype bf16`` leaves every ``req N:`` line as the run
    without the flag prints it."""
    from repro_torch.launch import serve
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--max-seq", "96", "--max-new", "3", "--prompt-len", "20",
            "--prefill-chunk", "16", "--cache-kind", "paged",
            "--page-size", "16"]
    runs = {}
    for extra in ([], ["--kv-dtype", "bf16"], ["--kv-dtype", "int8"]):
        assert serve.main(base + extra) == 0
        runs[" ".join(extra)] = capsys.readouterr().out
    q8 = runs["--kv-dtype int8"]
    assert "kv=int8 (" in q8 and " B/page, " in q8
    assert "decode KV bytes read" in q8
    assert "kv=bf16 (" in runs[""]

    def req(out):
        return [ln for ln in out.splitlines() if ln.startswith("  req ")]

    assert len(req(runs[""])) == 3
    assert req(runs["--kv-dtype bf16"]) == req(runs[""])
    assert len(req(q8)) == 3


def test_init_cache_quantized_layouts():
    """Quantized layouts: code pools in the spec's dtype and zeroed
    (L, NP, HK) f32 step pools; an unknown dtype is refused."""
    cfg = tconfigs.smoke(tconfigs.get(ARCH))
    api = tget_model(cfg)
    for name, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        layout = PagedLayout(12, 16, kv_dtype=name)
        cache = api.init_cache(layout, device="cpu")
        sshape = layout.scale_shape(cfg.num_layers, cfg.num_kv_heads)
        assert sshape == (cfg.num_layers, 12, cfg.num_kv_heads)
        assert cache["k"].dtype == cache["v"].dtype == dtype
        for leaf in ("k_scale", "v_scale"):
            assert cache[leaf].shape == sshape
            assert cache[leaf].dtype == torch.float32
            assert not cache[leaf].any()
        assert tkv.cache_is_quantized(cache)
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedLayout(12, 16, kv_dtype="int4")
