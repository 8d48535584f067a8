"""The port's paged KV-cache and self-speculative serving against the JAX
reference's.

Module tests start both sides from one paged state (the reference's,
carried across with ``paged_state_from_reference``) on the reference's
weights, reduced qwen2-0.5b and smollm-360m in fp32, and hold every block
pool and output at atol 1e-4 (PERF.md's bound for the reduced models),
tables, positions and ids exactly.  The paged logits, which the reference's
paged functions do not return, are held at the same bound against the
reference's slab ``prefill_state`` / ``decode_step`` on the same tokens:
the reference's own claim is that paged equals slab.

Pool tests are the reference's ``PagedDecodePool`` tests
(``tests/test_paged_serving.py``) on the port's balancer, with the same
fake model; whole-path tests hold the engine's tokens to the reference
engine's exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.runtime.serve_loop import ServingEngine as JaxEngine
from repro_torch.balancer import LoadBalancer, PagedDecodePool, PromptTooLongError
from repro_torch.configs import arch_from_reference
from repro_torch.models import (
    attention,
    build_model,
    lm,
    paged_state_from_reference,
    params_from_reference,
)
from repro_torch.runtime.serve_loop import (
    PagedGraphs,
    ServingEngine,
    make_speculative_fn,
    speculative_supported,
)

DENSE = ["qwen2-0.5b", "smollm-360m"]
ATOL = 1e-4
N_SLOTS, BLOCK_SIZE, CACHE_LEN = 3, 4, 16
MAX_BLOCKS = CACHE_LEN // BLOCK_SIZE
N_BLOCKS = 8  # usable; the pool has one more row, the scratch row 0
# Interleaved block rows, so that a write into the wrong slot's blocks shows.
ROWS = {0: [3, 7, 1, 0], 1: [2, 5, 8, 0], 2: [4, 6, 0, 0]}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(n,))


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    jcfg = JAX_ARCHS[request.param].reduced()
    jparams = jax_lm.init_params(jax.random.key(0), jcfg)
    cfg = arch_from_reference(jcfg)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _layer0(jparams, params):
    jattn = jax.tree.map(lambda x: x[0], jparams["blocks"]["attn"])
    return jattn, params["blocks"][0]["attn"]


def _to_port(jstate, cfg) -> lm.PagedDecodeState:
    return paged_state_from_reference(jax.tree.map(np.asarray, jstate), cfg, "cpu")


def _assert_states(st: lm.PagedDecodeState, jst) -> None:
    np.testing.assert_allclose(st.kv.k.numpy(), np.asarray(jst.kv.k), rtol=0, atol=ATOL)
    np.testing.assert_allclose(st.kv.v.numpy(), np.asarray(jst.kv.v), rtol=0, atol=ATOL)
    assert st.tables.tolist() == np.asarray(jst.tables).tolist()
    assert st.pos.tolist() == np.asarray(jst.pos).tolist()


def _leased_states(jcfg, cfg, slots=(0, 1, 2)):
    """Both sides' paged state with ``ROWS`` leased to ``slots``."""
    jst = jax_lm.init_paged_state(jcfg, N_SLOTS, N_BLOCKS + 1, BLOCK_SIZE, MAX_BLOCKS, CACHE_LEN)
    for slot in slots:
        jst = jax_lm.paged_reset_slot(jst, jnp.int32(slot), jnp.asarray(ROWS[slot], jnp.int32))
    st = _to_port(jst, cfg)
    return jst, st


def _chunk_both(model, jst, st, slot, chunk, start):
    jcfg, jparams, cfg, params = model
    jst, jtok = jax_lm.paged_prefill_chunk(
        jparams, jcfg, jst, jnp.int32(slot), jnp.asarray(chunk, jnp.int32), jnp.int32(start),
        CACHE_LEN,
    )
    st, ids, logits = lm.paged_prefill_chunk(
        params, cfg, st, torch.tensor(slot), _t(chunk), torch.tensor(start), CACHE_LEN
    )
    return jst, st, int(jtok), ids, logits


# ---------------------------------------------------------------------------
# Module functions against the reference's
# ---------------------------------------------------------------------------
def test_chunk_qkv_matches_reference(model):
    jcfg, jparams, cfg, params = model
    jattn, attn = _layer0(jparams, params)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    positions = np.arange(7, 12)
    got = attention.chunk_qkv(attn, _t(x), _t(positions), cfg)
    want = jax_attention.chunk_qkv(jattn, jnp.asarray(x), jnp.asarray(positions, jnp.int32), jcfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_attend_view_matches_reference(model, window):
    """Three rows at their own positions against the reference's B = 1
    read at each row's scalar position."""
    jcfg, jparams, cfg, params = model
    jcfg, cfg = (dataclasses.replace(c, sliding_window=window) for c in (jcfg, cfg))
    jattn, attn = _layer0(jparams, params)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, cfg.n_heads, 1, cfg.hd)).astype(np.float32)
    vk, vv = (rng.normal(size=(3, cfg.n_kv_heads, CACHE_LEN, cfg.hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 6, 15])
    got = attention.attend_view(attn, _t(q), _t(vk), _t(vv), _t(pos), cfg)
    assert got.shape == (3, 1, cfg.d_model)
    for b in range(3):
        want = jax_attention.attend_view(
            jattn, jnp.asarray(q[b : b + 1]), jnp.asarray(vk[b : b + 1]),
            jnp.asarray(vv[b : b + 1]), jnp.int32(pos[b]), jcfg,
        )
        np.testing.assert_allclose(got[b : b + 1].numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [None, 5])
def test_attend_view_chunk_matches_reference(model, window):
    jcfg, jparams, cfg, params = model
    jcfg, cfg = (dataclasses.replace(c, sliding_window=window) for c in (jcfg, cfg))
    jattn, attn = _layer0(jparams, params)
    rng = np.random.default_rng(2)
    c = 6
    q = rng.normal(size=(2, cfg.n_heads, c, cfg.hd)).astype(np.float32)
    vk, vv = (rng.normal(size=(2, cfg.n_kv_heads, CACHE_LEN, cfg.hd)).astype(np.float32)
              for _ in range(2))
    positions = np.arange(4, 4 + c)
    got = attention.attend_view_chunk(attn, _t(q), _t(vk), _t(vv), _t(positions), cfg)
    want = jax_attention.attend_view_chunk(
        jattn, jnp.asarray(q), jnp.asarray(vk), jnp.asarray(vv),
        jnp.asarray(positions, jnp.int32), jcfg,
    )
    assert got.shape == want.shape == (2, c, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_paged_reset_slot_matches_reference(model):
    """Table rows and positions, exactly, across leases, a chunk and a
    re-lease of a slot onto other rows."""
    jcfg, _, cfg, _ = model
    jst, st = _leased_states(jcfg, cfg, slots=(0, 2))
    _assert_states(st, jst)
    jst, st, _, _, _ = _chunk_both(model, jst, st, 2, _tokens(cfg, 5, 3), 0)
    assert st.pos.tolist() == [0, 0, 5]
    for slot, row in ((2, [8, 1, 0, 0]), (1, ROWS[1])):
        jst = jax_lm.paged_reset_slot(jst, jnp.int32(slot), jnp.asarray(row, jnp.int32))
        st = lm.paged_reset_slot(st, slot, np.asarray(row, np.int32))
        _assert_states(st, jst)
    assert st.pos.tolist() == [0, 0, 0] and st.tables[2].tolist() == [8, 1, 0, 0]


def test_paged_prefill_chunk_matches_reference(model):
    """Two slots prefilled in chunks of 3 (the last shorter): pools,
    positions and ids against the reference's chunks, the last position's
    logits against the reference's slab prefill of the same prefix."""
    jcfg, jparams, cfg, params = model
    jst, st = _leased_states(jcfg, cfg)
    for slot, n in ((0, 7), (1, 5)):
        prompt = _tokens(cfg, n, 10 + slot)
        for start in range(0, n, 3):
            chunk = prompt[start : start + 3]
            jst, st, jtok, ids, logits = _chunk_both(model, jst, st, slot, chunk, start)
            _assert_states(st, jst)
            assert ids.tolist() == [jtok]
            want, _ = jax_lm.prefill_state(
                jparams, jcfg, jnp.asarray(prompt[None, : start + len(chunk)], jnp.int32), CACHE_LEN
            )
            assert logits.shape == (1, 1, cfg.vocab)
            np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_paged_decode_step_matches_reference(model):
    """Steps with some slots inactive (slot 2 never leased, slot 1 paused
    for a step): pools, positions and ids against the reference's step,
    the active slots' logits against its slab decode of the same tokens."""
    jcfg, jparams, cfg, params = model
    jst, st = _leased_states(jcfg, cfg, slots=(0, 1))
    feeds, slabs = {}, {}
    for slot, n in ((0, 5), (1, 3)):
        prompt = _tokens(cfg, n, 20 + slot)
        jst, st, jtok, _, _ = _chunk_both(model, jst, st, slot, prompt, 0)
        feeds[slot] = jtok
        slabs[slot] = jax_lm.prefill_state(
            jparams, jcfg, jnp.asarray(prompt[None], jnp.int32), CACHE_LEN)[1]
    for active in ([True, True, False], [True, False, False], [True, True, False]):
        tokens = np.array([feeds[0], feeds[1], 7])
        jst, jtoks = jax_lm.paged_decode_step(
            jparams, jcfg, jst, jnp.asarray(tokens, jnp.int32), jnp.asarray(active), CACHE_LEN
        )
        st, ids, logits = lm.paged_decode_step(
            params, cfg, st, _t(tokens), torch.tensor(active), CACHE_LEN
        )
        _assert_states(st, jst)
        assert logits.shape == (N_SLOTS, 1, cfg.vocab)
        for slot in (0, 1):
            if not active[slot]:
                continue
            assert int(ids[slot]) == int(jtoks[slot])
            want, slabs[slot] = jax_lm.decode_step(
                jparams, jcfg, slabs[slot], jnp.full((1, 1), feeds[slot], jnp.int32))
            np.testing.assert_allclose(logits[slot].numpy(), np.asarray(want)[0], rtol=0,
                                       atol=ATOL)
            feeds[slot] = int(ids[slot])


def test_paged_decode_step_takes_a_slot_parked_at_the_cache_end(model):
    """A slot evicted after writing the cache's last position sits at pos
    == cache_len, one block past its table; stepping the others must not
    index past it."""
    jcfg, jparams, cfg, params = model
    jst, st = _leased_states(jcfg, cfg, slots=(0, 1))
    prompt = _tokens(cfg, CACHE_LEN, 25)
    for start in (0, CACHE_LEN // 2):
        jst, st, _, _, _ = _chunk_both(model, jst, st, 0, prompt[start : start + CACHE_LEN // 2],
                                       start)
    jst, st, jtok, _, _ = _chunk_both(model, jst, st, 1, _tokens(cfg, 3, 26), 0)
    assert st.pos.tolist() == [CACHE_LEN, 3, 0]
    active = [False, True, False]
    jst, jtoks = jax_lm.paged_decode_step(jparams, jcfg, jst, jnp.asarray([0, jtok, 0], jnp.int32),
                                          jnp.asarray(active), CACHE_LEN)
    st, ids, _ = lm.paged_decode_step(params, cfg, st, torch.tensor([0, jtok, 0]),
                                      torch.tensor(active), CACHE_LEN)
    _assert_states(st, jst)
    assert int(ids[1]) == int(jtoks[1])


def test_slot_evict_empties_one_row(model):
    _, _, cfg, params = model
    pool = lm.pool_decode_state(cfg, 3, CACHE_LEN, "cpu")
    for slot, n in ((0, 4), (1, 6)):
        _, st = lm.prefill_state(params, cfg, _t(_tokens(cfg, n, 30 + slot)[None]), CACHE_LEN)
        lm.slot_insert(pool, st, slot)
    kept = pool.kv.k[:, 1].clone()
    pool = lm.slot_evict(pool, cfg, CACHE_LEN, 0)
    assert not pool.kv.k[:, 0].any() and not pool.kv.v[:, 0].any()
    assert pool.kv.pos_buf[0].eq(-1).all() and pool.pos.tolist() == [0, 6, 0]
    assert torch.equal(pool.kv.k[:, 1], kept)


def test_paged_support_refuses_a_wrapping_cache(model):
    _, _, cfg, _ = model
    lm.check_paged_support(cfg, CACHE_LEN)
    lm.check_paged_support(dataclasses.replace(cfg, sliding_window=CACHE_LEN), CACHE_LEN)
    short = dataclasses.replace(cfg, sliding_window=CACHE_LEN - 1)
    with pytest.raises(ValueError, match="sliding_window"):
        lm.check_paged_support(short, CACHE_LEN)
    with pytest.raises(ValueError, match="sliding_window"):
        lm.init_paged_state(short, 2, 5, BLOCK_SIZE, MAX_BLOCKS, CACHE_LEN, "cpu")
    assert speculative_supported(cfg, CACHE_LEN) and not speculative_supported(short, CACHE_LEN)


# ---------------------------------------------------------------------------
# PagedGraphs: the pool's static state and its graphs (eager on the CPU)
# ---------------------------------------------------------------------------
def _clone(st: lm.PagedDecodeState) -> lm.PagedDecodeState:
    return lm.PagedDecodeState(
        kv=attention.PagedKVCache(st.kv.k.clone(), st.kv.v.clone()),
        tables=st.tables.clone(), pos=st.pos.clone(),
    )


def test_paged_graphs_equal_the_eager_functions(model):
    """Through the graphs' static buffers, chunks and steps equal the eager
    functions on a copy of the state, also after slot 1 was moved onto
    other block rows: the tables are read from the state at each call."""
    _, _, cfg, params = model
    g = PagedGraphs(build_model(cfg), params, n_slots=N_SLOTS, n_blocks=N_BLOCKS,
                    block_size=BLOCK_SIZE, cache_len=CACHE_LEN, name="test")

    def chunks(slot, seed):
        prompt = _tokens(cfg, 6, seed)
        for start in (0, 3):
            ref = _clone(g.state)
            want = lm.paged_prefill_chunk(params, cfg, ref, torch.tensor(slot),
                                          _t(prompt[start : start + 3]), torch.tensor(start),
                                          CACHE_LEN)
            ids, logits = g.chunk(slot, prompt[start : start + 3], start)
            assert torch.equal(ids, want[1]) and torch.equal(logits, want[2])
            assert torch.equal(g.state.pos, want[0].pos)

    def steps():
        active = torch.tensor([True, True, False])
        for feed in ([5, 9, 0], [11, 3, 0]):
            ref = _clone(g.state)
            want = lm.paged_decode_step(params, cfg, ref, torch.tensor(feed), active, CACHE_LEN)
            ids, logits = g.step(torch.tensor(feed), active)
            assert torch.equal(ids, want[1]) and torch.equal(logits, want[2])
            assert torch.equal(g.state.pos, want[0].pos)
            assert torch.equal(g.state.kv.k, ref.kv.k) and torch.equal(g.state.kv.v, ref.kv.v)

    for slot in (0, 1):
        lm.paged_reset_slot(g.state, slot, ROWS[slot])
        chunks(slot, 40 + slot)
    steps()
    lm.paged_reset_slot(g.state, 1, [6, 4, 2, 0])
    chunks(1, 42)
    steps()
    assert sorted(g.chunks) == [3]


def test_swapping_two_slots_table_rows_changes_their_tokens(model):
    """The teeth of the block tables: two live slots decode alike twice;
    swapping their table rows mid-generation in the second run changes
    what both emit, because each then reads the other's keys and values."""
    _, _, cfg, params = model

    def run(swap_at):
        g = PagedGraphs(build_model(cfg), params, n_slots=2, n_blocks=N_BLOCKS,
                        block_size=BLOCK_SIZE, cache_len=CACHE_LEN, name="teeth")
        feeds = []
        for slot in (0, 1):
            lm.paged_reset_slot(g.state, slot, ROWS[slot])
            ids, _ = g.chunk(slot, _tokens(cfg, 6, 50 + slot), 0)
            feeds.append(int(ids[0]))
        out = [list(feeds)]
        for step in range(6):
            if step == swap_at:
                g.state.tables[[0, 1]] = g.state.tables[[1, 0]].clone()
            ids, _ = g.step(torch.tensor(feeds), torch.tensor([True, True]))
            feeds = ids.tolist()
            out.append(feeds)
        return np.array(out)

    plain, again, swapped = run(None), run(None), run(2)
    assert np.array_equal(plain, again)
    assert np.array_equal(plain[:3], swapped[:3])
    for slot in (0, 1):
        assert not np.array_equal(plain[3:, slot], swapped[3:, slot]), slot


# ---------------------------------------------------------------------------
# The port's PagedDecodePool: the reference's pool tests, same fake model
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def fake_paged_pool(n_slots=4, *, n_blocks=3, block_size=4, max_blocks_per_slot=2,
                    max_positions=8, prefill_chunk=2, clock=None):
    """A PagedDecodePool whose 'model' emits last input + 1: ``chunk_fn``
    returns ``chunk[-1] + 1``, ``step_fn`` ``tokens + 1``, so a prompt
    ``[10, 11]`` streams ``[12, 13, 14, ...]``."""

    def step_fn(state, toks, active):
        return state + 1, np.asarray(toks) + 1

    def chunk_fn(state, slot, chunk, start_pos):
        return state + 1, int(chunk[-1]) + 1

    return PagedDecodePool(
        step_fn, chunk_fn, lambda state, slot, row: state, lambda: 0, n_slots,
        n_blocks=n_blocks, block_size=block_size, max_blocks_per_slot=max_blocks_per_slot,
        max_positions=max_positions, prefill_chunk=prefill_chunk, clock=clock or FakeClock(),
    )


def theta(prompt, n_new, eos=None):
    return (np.asarray(prompt, dtype=np.int64).reshape(1, -1), n_new, eos)


class _FakeReq:
    """Just enough of a Request for direct pool.admit() calls."""

    def __init__(self, th):
        self.theta = th
        self.tag = ""


def test_chunked_prefill_token_stream_and_ttft_boundary():
    """The first token comes at the boundary where the prompt completes,
    and that boundary's decode step appends the second."""
    pool = fake_paged_pool(n_slots=1)
    lb = LoadBalancer([pool])
    res = lb.result(lb.submit_async(theta([10, 11, 12], 4), tag=""), timeout=5)
    assert res.tokens.tolist() == [13, 14, 15, 16]
    assert res.token_times == sorted(res.token_times) and len(res.token_times) == 4
    assert pool.block_usage() == (0, pool.n_blocks)
    lb.shutdown()


def test_block_backpressure_preserves_fifo_head_of_line():
    """A head that does not fit in the free blocks holds later requests
    that would fit: admission stays FIFO."""
    pool = fake_paged_pool(n_slots=4, n_blocks=3, block_size=4)
    lb = LoadBalancer([pool])
    reqs = [lb.submit_async(theta([1, 2], n), tag="") for n in (2, 5, 5, 2)]
    for r in reqs:
        lb.result(r, timeout=5)
    assert [req for _, req in pool.admit_log] == reqs, "block backpressure broke FIFO"
    assert pool.block_usage() == (0, 3) and pool.n_free == pool.n_slots
    lb.shutdown()


def test_chunked_prefill_fifo_fairness_on_fake_clock():
    """With one slot, the second request's whole generation, chunked
    prefill included, comes after the first completes."""
    pool = fake_paged_pool(n_slots=1, clock=FakeClock(), max_positions=8)
    lb = LoadBalancer([pool])
    ra = lb.submit_async(theta([1, 2, 3, 4], 2), tag="")
    rb = lb.submit_async(theta([5, 6, 7, 8], 2), tag="")
    res_a, res_b = lb.result(ra, timeout=5), lb.result(rb, timeout=5)
    assert res_a.tokens.tolist() == [5, 6] and res_b.tokens.tolist() == [9, 10]
    assert res_b.token_times[0] > res_a.token_times[-1]
    lb.shutdown()


def test_no_block_leak_on_eos_length_eviction_and_death():
    pool = fake_paged_pool(n_slots=4, n_blocks=3, block_size=4)
    lb = LoadBalancer([pool])
    r_eos = lb.submit_async(theta([5, 6], 6, eos=8), tag="")
    r_len = lb.submit_async(theta([1, 2], 3), tag="")
    assert lb.result(r_eos, timeout=5).tokens.tolist() == [7, 8]
    assert lb.result(r_len, timeout=5).tokens.tolist() == [3, 4, 5]
    assert pool.block_usage() == (0, 3) and sorted(pool._free_blocks) == [1, 2, 3]
    assert pool.n_free == pool.n_slots
    lb.shutdown()

    dying = fake_paged_pool(n_slots=2, n_blocks=3, block_size=4)
    dying.admit(_FakeReq(theta([1, 2], 5)), now=0.0)
    dying.admit(_FakeReq(theta([1, 2], 2)), now=0.0)
    assert dying.block_usage() == (3, 3)
    dying.clear()
    assert dying.block_usage() == (0, 3) and dying.n_free == dying.n_slots


def test_never_fits_raises_typed_error_and_pool_survives():
    pool = fake_paged_pool(n_slots=2, n_blocks=3, block_size=4, max_positions=8)
    with pytest.raises(PromptTooLongError):
        pool.admit(_FakeReq(theta([1] * 6, 4)), now=0.0)  # 9 positions > 8
    with pytest.raises(PromptTooLongError):
        pool.admit(_FakeReq(theta([], 4)), now=0.0)
    assert pool.block_usage() == (0, 3) and pool.n_free == pool.n_slots
    assert pool.admissible(theta([1] * 6, 4))  # popped for the typed rejection

    lb = LoadBalancer([pool])
    r_bad = lb.submit_async(theta([1] * 6, 4), tag="")
    r_ok = lb.submit_async(theta([1, 2], 2), tag="")
    with pytest.raises(PromptTooLongError):
        lb.result(r_bad, timeout=5)
    assert lb.result(r_ok, timeout=5).tokens.tolist() == [3, 4]
    assert lb.telemetry.fault_count("rejected") == 1
    lb.shutdown()


# ---------------------------------------------------------------------------
# The MoE family's paged functions against the reference's
# ---------------------------------------------------------------------------
MOE = "granite-moe-3b-a800m"
# Slot 0 fills its four blocks (chunks of 12 and 1, then steps), slot 1
# two; slot 2 is never leased.
MOE_ROWS = {0: [3, 7, 1, 8], 1: [2, 5, 0, 0]}


@pytest.fixture(scope="module")
def granite():
    jcfg = JAX_ARCHS[MOE].reduced()
    return jcfg, jax_lm.init_params(jax.random.key(2), jcfg)


@pytest.mark.parametrize("capacity_factor", [None, 8.0])
def test_moe_paged_functions_match_reference(granite, capacity_factor):
    """From one carried-across state: chunks of 12 and 1 positions into
    slot 0 and of 5 into slot 1, then steps with slots inactive, against
    the reference's ``paged_prefill_chunk`` and ``paged_decode_step``:
    pools, positions and ids.  A chunk routes as one sequence, so at the
    reduced config's own capacity factor the 12-position chunk drops pairs
    (24 over 4 experts of 8 rows each), the same pairs as the reference's,
    and its logits leave the slab prefill's, which routes token by token;
    at 8 no pair drops, and the logits equal the reference's slab prefill
    and decode of the same tokens."""
    jcfg, jparams = granite
    if capacity_factor is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
    cfg = arch_from_reference(jcfg)
    model = (jcfg, jparams, cfg, params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                                        "cpu"))
    jst = jax_lm.init_paged_state(jcfg, N_SLOTS, N_BLOCKS + 1, BLOCK_SIZE, MAX_BLOCKS, CACHE_LEN)
    for slot, rows in MOE_ROWS.items():
        jst = jax_lm.paged_reset_slot(jst, jnp.int32(slot), jnp.asarray(rows, jnp.int32))
    st = _to_port(jst, cfg)
    feeds, slabs = {}, {}
    for slot, pieces in ((0, (12, 1)), (1, (5,))):
        prompt = _tokens(cfg, sum(pieces), 30 + slot)
        start = 0
        for n in pieces:
            jst, st, jtok, ids, logits = _chunk_both(model, jst, st, slot,
                                                     prompt[start : start + n], start)
            _assert_states(st, jst)
            assert ids.tolist() == [jtok]
            want, slabs[slot] = jax_lm.prefill_state(
                jparams, jcfg, jnp.asarray(prompt[None, : start + n], jnp.int32), CACHE_LEN)
            diff = float(np.abs(logits.numpy() - np.asarray(want)).max())
            if capacity_factor is not None:
                assert diff <= ATOL
            elif n == 12:
                assert diff > 100 * ATOL  # the dropped pairs show
            start += n
        feeds[slot] = jtok
    for active in ([True, True, False], [True, False, False], [False, True, False]):
        tokens = np.array([feeds[0], feeds[1], 7])
        jst, jtoks = jax_lm.paged_decode_step(
            jparams, jcfg, jst, jnp.asarray(tokens, jnp.int32), jnp.asarray(active), CACHE_LEN)
        st, ids, logits = lm.paged_decode_step(
            model[3], cfg, st, _t(tokens), torch.tensor(active), CACHE_LEN)
        _assert_states(st, jst)
        for slot in (0, 1):
            if not active[slot]:
                continue
            assert int(ids[slot]) == int(jtoks[slot])
            want, slabs[slot] = jax_lm.decode_step(
                jparams, jcfg, slabs[slot], jnp.full((1, 1), feeds[slot], jnp.int32))
            if capacity_factor is not None:
                np.testing.assert_allclose(logits[slot].numpy(), np.asarray(want)[0], rtol=0,
                                           atol=ATOL)
            feeds[slot] = int(ids[slot])
    assert st.pos.tolist() == [15, 7, 0]


# ---------------------------------------------------------------------------
# Whole path: the engine's tokens against the reference engine's
# ---------------------------------------------------------------------------
def _mixed_work(rng):
    """``tests/test_paged_serving.py``'s workload for one variant."""
    return [(rng.integers(0, 200, size=(1, 3)), n_new) for n_new in (4, 1, 6, 2)]


ENGINE_KW = {"paged": {"n_slots": 3, "block_size": 8, "prefill_chunk": 2},
             "speculative": {"spec_k": 3}}


@pytest.mark.parametrize("mode", ["paged", "speculative"])
@pytest.mark.parametrize("arch", DENSE)
def test_tokens_equal_the_reference_engine(arch, mode):
    jcfg = JAX_ARCHS[arch].reduced()
    work = _mixed_work(np.random.default_rng(0))
    with JaxEngine({arch: jcfg}, mode=mode, cache_len=24, **ENGINE_KW[mode]) as eng:
        want = [eng.submit(arch, p, n).result(timeout=300).tokens.tolist() for p, n in work]
        jparams = jax.tree.map(np.asarray, eng.params[arch])
    cfg = arch_from_reference(jcfg)
    params = {arch: params_from_reference(jparams, cfg, "cpu")}
    with ServingEngine({arch: cfg}, mode=mode, cache_len=24, device="cpu", params=params,
                       **ENGINE_KW[mode]) as eng:
        gens = [eng.submit(arch, p, n) for p, n in work]
        got = [g.result(timeout=120).tokens.tolist() for g in gens]
        summary = eng.summary()
    assert got == want
    if mode == "paged":
        occ = summary["block_occupancy"][f"paged:{arch}#0"]
        assert 0.0 < occ["mean"] <= 1.0 and summary["slot_occupancy"]
    else:
        sp = summary["spec_accept"][f"spec:{arch}"]
        assert sp["rounds"] > 0 and sp["drafted"] > 0 and 0.0 <= sp["rate"] <= 1.0


@pytest.mark.parametrize("arch,mode", [
    ("mamba2-1.3b", "paged"), ("mamba2-1.3b", "speculative"),
    ("granite-moe-3b-a800m", "paged"), ("granite-moe-3b-a800m", "speculative"),
])
def test_family_tokens_equal_the_reference_engine(arch, mode):
    """The reference's REAL_ARCHS cover mamba2 in paged mode (a pool of no
    blocks: the slots' recurrent state and chunked prefill); granite's
    paged pool has blocks and routes each chunk as one sequence, as the
    reference's does.  mamba2's speculative server is plain greedy under
    the spec tag (no telemetry), granite's drafts with its bottom half."""
    jcfg = JAX_ARCHS[arch].reduced()
    work = _mixed_work(np.random.default_rng(1))
    with JaxEngine({arch: jcfg}, mode=mode, cache_len=24, **ENGINE_KW[mode]) as eng:
        want = [eng.submit(arch, p, n).result(timeout=300).tokens.tolist() for p, n in work]
        jparams = jax.tree.map(np.asarray, eng.params[arch])
    cfg = arch_from_reference(jcfg)
    params = {arch: params_from_reference(jparams, cfg, "cpu")}
    with ServingEngine({arch: cfg}, mode=mode, cache_len=24, device="cpu", params=params,
                       **ENGINE_KW[mode]) as eng:
        got = [g.result(timeout=120).tokens.tolist() for g in
               [eng.submit(arch, p, n) for p, n in work]]
        summary = eng.summary()
        pools = [s for s in eng.lb.servers if isinstance(s, PagedDecodePool)]
    assert got == want
    if mode == "paged":
        assert [p.n_blocks == 0 for p in pools] == [cfg.family == "ssm"]
        assert summary["slot_occupancy"]
    elif cfg.family == "moe":
        assert summary["spec_accept"][f"spec:{arch}"]["rounds"] > 0
    else:
        assert not summary.get("spec_accept")


def test_hybrid_paged_is_refused_and_recurrent_spec_servers_fall_back():
    """zamba2's caches are not block-structured: paged is refused with the
    reference's message.  A recurrent state cannot rewind, so mamba2 and
    zamba2 have no self-speculative server; the engine serves them plain
    greedy under the spec tag, with generation's tokens."""
    hybrid = arch_from_reference(JAX_ARCHS["zamba2-1.2b"].reduced())
    for kw in ({"mode": "paged"}, {"kv": "paged"}):
        with pytest.raises(ValueError, match="hybrid/encdec caches are not block-structured"):
            ServingEngine({"h": hybrid}, cache_len=24, device="cpu", **kw)
    ssm_cfg = arch_from_reference(JAX_ARCHS["mamba2-1.3b"].reduced())
    moe_cfg = arch_from_reference(JAX_ARCHS["granite-moe-3b-a800m"].reduced())
    assert speculative_supported(moe_cfg, 24)
    for cfg in (hybrid, ssm_cfg):
        assert not speculative_supported(cfg, 24)
        with pytest.raises(ValueError, match="KV family"):
            make_speculative_fn(build_model(cfg), None, 24)
    work = _mixed_work(np.random.default_rng(2))
    out = {}
    for mode in ("speculative", "generation"):
        with ServingEngine({"h": hybrid}, mode=mode, cache_len=24, device="cpu", seed=3) as eng:
            out[mode] = [eng.submit("h", p, n).result(timeout=120).tokens.tolist()
                         for p, n in work]
            assert not eng.summary().get("spec_accept")
    assert out["speculative"] == out["generation"]


def test_kv_paged_promotes_continuous_and_validates_prompts():
    cfg = arch_from_reference(JAX_ARCHS["qwen2-0.5b"].reduced())
    with ServingEngine({"m": cfg}, kv="paged", n_slots=2, cache_len=24, block_size=8,
                       device="cpu") as eng:
        assert eng.mode == "paged"
        with pytest.raises(PromptTooLongError):  # 22 + 4 - 1 = 25 > 24
            eng.submit("m", np.zeros((1, 22), np.int64), 4)
        with pytest.raises(PromptTooLongError):
            eng.submit("m", np.zeros((1, 0), np.int64), 4)
        assert len(eng.submit("m", np.array([[1, 2, 3]]), 2).result(timeout=60).tokens) == 2
