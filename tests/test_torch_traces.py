"""The port's streamed trace replay (``repro_torch.traces`` and
``CodedMemorySystem.run_chunk``) on the CPU against the JAX package, bit for
bit: streamed = single-shot at every chunk length, window series, each of
``run_chunk``'s three exits, the file formats and their errors, the
rolling-window source, the profiler and region priors.

The geometry is ``tests/test_traces.py``'s (32 rows, 3 cores, length 10,
scheme_i, alpha 0.25, r 0.125, recode cap 8, select period 8); inputs are
made with numpy from a seed and handed to both sides."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import rand_trace
from test_torch_sim import _jtrace_to_port, assert_states_equal
from test_traces import _GARBAGE_LINES, _FlakyChunks, _split

from repro.core import codes as jcodes
from repro.core import state as jstate
from repro.core import system as jsys
from repro import traces as jtraces
from repro.traces import formats as jformats
from repro.traces import source as jsource
from repro_torch.core import codes, state, system
from repro_torch.core.state import INT32_MAX
from repro_torch import traces
from repro_torch.traces import formats, source, stream

DATA = os.path.join(os.path.dirname(__file__), "data")
CPU = "cpu"
N_ROWS, N_CORES, TLEN = 32, 3, 10


def _systems(alpha=0.25, r=0.125, **tn_kw):
    jt = jcodes.get_tables("scheme_i")
    jp = jstate.make_params(jt, n_rows=N_ROWS, alpha=alpha, r=r, recode_cap=8)
    tt = codes.get_tables("scheme_i")
    tp = state.make_params(tt, n_rows=N_ROWS, alpha=alpha, r=r, recode_cap=8)
    return (jsys.CodedMemorySystem(
                jt, jp, n_cores=N_CORES,
                tunables=jstate.make_tunables(select_period=8, **tn_kw)),
            system.CodedMemorySystem(
                tt, tp, n_cores=N_CORES, device=CPU,
                tunables=state.make_tunables(select_period=8, **tn_kw)))


# one JAX system (one jit cache) for the module
JSYS, TSYS = _systems()


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """JAX compiles this file's programs at XLA's backend optimization
    level 0 (``jax_disable_most_optimizations``; the simulator is integer
    arithmetic, so its results do not depend on it) and torch runs on one
    intra-op thread, as in ``tests/test_torch_faults.py``: a worker of the
    6-worker run died of a segmentation fault inside XLA's optimizing
    compile of JAX's streamed replay. Both settings are restored after
    the module's tests."""
    saved = (jax.config.read("jax_disable_most_optimizations"),
             torch.get_num_threads())
    jax.config.update("jax_disable_most_optimizations", True)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_disable_most_optimizations", saved[0])
    torch.set_num_threads(saved[1])


def _trace(seed, length=TLEN, n_cores=N_CORES):
    jtr = rand_trace(np.random.default_rng(seed), n_cores, length, 8, N_ROWS)
    return jtr, _jtrace_to_port(jtr)


def _assert_traces_equal(got, want, label=""):
    """A port Trace (tensors or arrays) equals a JAX one, field by field,
    dtypes included."""
    for name, g, w in zip(jsys.Trace._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, f"{label}: {name} dtype"
        np.testing.assert_array_equal(g, w, err_msg=f"{label}: {name}")


# ------------------------------------------------------------ chunked replay
@pytest.mark.parametrize("chunk_len", [1, 3, 10, 14])
def test_stream_replay_equals_single_shot_and_jax(chunk_len):
    """Any chunk length, 1 and longer than the trace included: the port's
    streamed replay equals its own single-shot ``run`` and JAX's (windows
    stripped), and its window series equal JAX ``stream_replay``'s."""
    jtr, ttr = _trace(5)
    single = JSYS.run(jtr, jsys.drain_bound(N_CORES, TLEN))
    assert TSYS.run(ttr, system.drain_bound(N_CORES, TLEN)) == single
    got = traces.stream_replay(TSYS, ttr, chunk_len=chunk_len)
    assert traces.strip_windows(got) == single
    want = jtraces.stream_replay(JSYS, jtr, chunk_len=chunk_len)
    assert got == want
    assert len(got.window_read_latency) >= -(-TLEN // chunk_len)


def test_stream_replay_random_splits_invisible():
    """How the source is cut into chunks never shows: seeded random splits
    (and JAX test_traces' fixed ones) of one trace, staged at several chunk
    lengths, all equal the single-shot run."""
    jtr, ttr = _trace(9)
    single = JSYS.run(jtr, jsys.drain_bound(N_CORES, TLEN))
    rng = np.random.default_rng(17)
    splits = [[2], [1, 2, 3, 4, 9], [5], []] + [
        sorted(rng.choice(np.arange(1, TLEN), rng.integers(1, 6),
                          replace=False).tolist()) for _ in range(4)]
    for cuts in splits:
        for chunk_len in (2, 4):
            chunks = (system.Trace(*(torch.from_numpy(np.array(x))
                                     for x in c)) for c in _split(jtr, cuts))
            got = traces.stream_replay(TSYS, chunks, chunk_len=chunk_len)
            assert traces.strip_windows(got) == single, (cuts, chunk_len)


def test_stream_replay_stops_at_quiescence_before_the_bound():
    """The quiescent exit: the streamed run leaves the drained tail out
    (fewer cycles than ``drain_bound``), with the same result."""
    jtr, ttr = _trace(5)
    st = TSYS.init()
    src = traces.as_source(ttr)
    chunk, se = src.stage(np.zeros(N_CORES, np.int64), TLEN, CPU)
    st = TSYS.run_chunk(st, chunk, se, traces.chunk_bound(TSYS, TLEN))
    assert bool(system.quiescent(st))
    assert int(st.mem.cycle) < system.drain_bound(N_CORES, TLEN)


def test_stream_replay_max_cycles_matches_jax():
    """``max_cycles`` stops a replay after the chunk that reaches it, where
    JAX's stops, reporting ``completed=False``."""
    jtr, ttr = _trace(5)
    for max_cycles in (1, 4, 9):
        got = traces.stream_replay(TSYS, ttr, chunk_len=3,
                                   max_cycles=max_cycles)
        want = jtraces.stream_replay(JSYS, jtr, chunk_len=3,
                                     max_cycles=max_cycles)
        assert got == want, max_cycles
        assert not got.completed


@pytest.mark.parametrize("chunk_len", [3, TLEN + 4])
def test_stream_replay_returns_its_state_and_sees_every_cycle(chunk_len):
    """``return_state`` hands back the state the result was read from, and
    ``on_cycle`` sees every cycle of every chunk in order, the last one
    ending in that state. Staged whole, the state equals JAX
    ``run_chunk``'s to quiescence leaf by leaf."""
    jtr, ttr = _trace(5)
    seen = []
    res, st = traces.stream_replay(
        TSYS, ttr, chunk_len=chunk_len, return_state=True,
        on_cycle=lambda before, after, out: seen.append((before, after)))
    assert res == traces.stream_replay(TSYS, ttr, chunk_len=chunk_len)
    assert TSYS.summarize(st) == traces.strip_windows(res)
    assert [int(b.mem.cycle) for b, _ in seen] == list(
        range(int(st.mem.cycle)))
    for x, y in zip(seen[-1][1].mem, st.mem):
        assert (x is None and y is None) or torch.equal(x, y)
    if chunk_len > TLEN:
        jc, jse, _, _ = _stage(jtr, ttr, chunk_len, False)
        jst = JSYS.run_chunk(JSYS.init(), jc, jse,
                             traces.chunk_bound(TSYS, chunk_len),
                             JSYS.tunables)
        assert_states_equal(jst, st, "whole trace staged")


# ---------------------------------------------------------------- run_chunk
def _stage(jtr, ttr, chunk_len, more: bool):
    """Both sides' staging buffers from position 0: the first
    ``chunk_len`` columns with INT32_MAX stream ends when ``more`` data lies
    behind, else the whole trace through each side's source (a chunk
    longer than the trace ends each core's stream inside it)."""
    if not more:
        pos = np.zeros(N_CORES, np.int64)
        return (jsource.TraceSource.from_trace(jtr).stage(pos, chunk_len)
                + source.TraceSource.from_trace(ttr).stage(pos, chunk_len,
                                                           CPU))
    cols = [np.array(x)[:, :chunk_len] for x in jtr]
    se = np.full(N_CORES, INT32_MAX, np.int32)
    return (jsys.Trace(*(jnp.asarray(c) for c in cols)), jnp.asarray(se),
            system.Trace(*(torch.from_numpy(c) for c in cols)),
            torch.from_numpy(se))


@pytest.mark.parametrize("exit_", ["starved", "quiescent", "budget"])
def test_run_chunk_matches_jax_at_each_exit(exit_):
    """One ``run_chunk`` call from a fresh state leaves every leaf equal to
    JAX ``run_chunk``'s, for each way out of its loop. The quiescent and
    budget cases stage the whole trace in a longer chunk, so each core's
    pointer must stop at its stream end, not at the chunk's end."""
    jtr, ttr = _trace(7)
    chunk_len, more, budget = {
        "starved": (4, True, traces.chunk_bound(TSYS, 4)),
        "quiescent": (TLEN + 4, False, traces.chunk_bound(TSYS, TLEN + 4)),
        "budget": (TLEN + 4, False, 5)}[exit_]
    jc, jse, tc, tse = _stage(jtr, ttr, chunk_len, more)
    assert tse.tolist() == ([INT32_MAX] * N_CORES if more else [TLEN] * 3)
    jst = JSYS.run_chunk(JSYS.init(), jc, jse, budget, JSYS.tunables)
    tst = TSYS.run_chunk(TSYS.init(), tc, tse, budget)
    assert_states_equal(jst, tst, exit_)
    ran = int(tst.mem.cycle)
    starved = bool(((tst.core_ptr >= chunk_len) & (tse > chunk_len)).any())
    quiet = bool(system.quiescent(tst))
    assert (starved, quiet, ran == budget) == (
        exit_ == "starved", exit_ == "quiescent", exit_ == "budget")
    if exit_ == "quiescent":
        assert tst.core_ptr.tolist() == [TLEN] * N_CORES


def test_stream_end_none_is_the_single_shot_cycle():
    """``stream_end=None`` is the single-shot program: 40 cycles with None
    equal JAX's cycle with None, and equal the port's cycle given every
    core's trace length as its stream end."""
    jtr, ttr = _trace(3, length=16)
    se = torch.full((N_CORES,), 16, dtype=torch.int32)
    jst, a, b = JSYS.init(), TSYS.init(), TSYS.init()
    for _ in range(40):
        jst, _ = JSYS.cycle_fn(jst, jtr)
        a, out_a = TSYS.cycle_fn(a, ttr)
        b, out_b = TSYS.cycle_fn(b, ttr, stream_end=se)
        for x, y in zip(out_a, out_b):
            assert torch.equal(x, y)
    assert_states_equal(jst, a, "None")
    assert_states_equal(jst, b, "stream_end = trace length")


# ------------------------------------------------------------------ formats
def test_ramulator_fixture_matches_jax():
    path = os.path.join(DATA, "tiny_ramulator.trace")
    assert list(formats.iter_ramulator(path)) == \
        list(jformats.iter_ramulator(path))
    kw = dict(n_cores=2, n_banks=4, n_rows=8)
    _assert_traces_equal(formats.load_trace(path, device=CPU, **kw),
                         jformats.load_trace(path, **kw), "ramulator")
    assert formats.count_requests(path) == jformats.count_requests(path)


def test_gem5_fixture_matches_jax():
    path = os.path.join(DATA, "tiny_gem5.gem5")
    assert list(formats.iter_gem5(path)) == list(jformats.iter_gem5(path))
    kw = dict(n_cores=1, n_banks=4, n_rows=8, line_bytes=64)
    _assert_traces_equal(formats.load_trace(path, device=CPU, **kw),
                         jformats.load_trace(path, **kw), "gem5")
    kw = dict(n_cores=2, n_banks=4, n_rows=8, length=4)
    _assert_traces_equal(formats.load_trace(path, device=CPU, **kw),
                         jformats.load_trace(path, **kw), "gem5 padded")


def test_npz_fixture_matches_jax():
    path = os.path.join(DATA, "tiny_trace.npz")
    _assert_traces_equal(formats.load_npz(path, CPU),
                         jformats.load_npz(path), "npz")
    _assert_traces_equal(formats.load_trace(path, device=CPU),
                         jformats.load_trace(path), "npz via load_trace")
    assert formats.probe(path) == jformats.probe(path)


def test_npz_save_load_roundtrip(tmp_path):
    jtr, ttr = _trace(4, length=9)
    path = formats.save_npz(os.path.join(tmp_path, "t.npz"), ttr)
    back = formats.load_npz(path, CPU)
    for a, b in zip(back, ttr):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_traces_equal(back, jformats.load_npz(path), "JAX reads it")


def test_stream_file_equals_load_trace_and_jax(tmp_path):
    """Chunked file reading deals requests and payloads exactly as a whole
    load does (the short tail chunk included), chunk for chunk as JAX's."""
    lines = [f"{16 * i + (i % 5)} {'W' if i % 3 == 0 else 'R'}\n"
             for i in range(23)]
    path = os.path.join(tmp_path, "long.trace")
    with open(path, "w") as f:
        f.writelines(lines)
    kw = dict(n_cores=2, n_banks=4, n_rows=32)
    whole = formats.load_trace(path, device=CPU, **kw)
    _assert_traces_equal(whole, jformats.load_trace(path, **kw), "whole")
    for chunk_len in (4, 9):
        chunks = list(formats.stream_file(path, chunk_len, **kw))
        want = list(jformats.stream_file(path, chunk_len, **kw))
        assert len(chunks) == len(want)
        for c, w in zip(chunks, want):
            _assert_traces_equal(c, w, f"chunk_len={chunk_len}")
        for f, w in zip(system.Trace._fields, whole):
            cat = np.concatenate([getattr(c, f) for c in chunks], axis=1)
            np.testing.assert_array_equal(cat, w.numpy(), err_msg=f)
    npz = formats.save_npz(os.path.join(tmp_path, "w.npz"), whole)
    for c, w in zip(formats.stream_file(npz, 5),
                    jformats.stream_file(npz, 5)):
        _assert_traces_equal(c, w, "npz chunks")


def test_requests_to_trace_matches_jax_and_refuses_truncation():
    rng = np.random.default_rng(6)
    addrs = rng.integers(0, 1 << 16, 37)
    isw = rng.random(37) < 0.4
    for kw in (dict(n_cores=3), dict(n_cores=4, line_bytes=64, length=12)):
        _assert_traces_equal(
            formats.requests_to_trace(addrs, isw, device=CPU, **kw),
            jformats.requests_to_trace(addrs, isw, **kw), str(kw))
    with pytest.raises(ValueError, match="stream has 10"):
        formats.requests_to_trace(np.arange(10), np.zeros(10, bool),
                                  n_cores=2, length=3, device=CPU)


def _raised(fn, *args):
    with pytest.raises(Exception) as ei:
        fn(*args)
    return ei.value


def test_malformed_text_traces_name_the_file_and_line_as_jax(tmp_path):
    """Garbage lines spliced into good Ramulator and gem5 traces raise
    ``TraceFormatError`` with JAX's file, line and message."""
    rng = np.random.default_rng(7)
    good = {"ramulator": [f"0x{rng.integers(0, 1 << 20):x} "
                          f"{'R' if rng.random() < 0.5 else 'W'}"
                          for _ in range(8)],
            "gem5": [f"{i},{'r' if rng.random() < 0.5 else 'w'},"
                     f"0x{rng.integers(0, 1 << 20):x}" for i in range(8)]}
    ext = {"ramulator": ".trace", "gem5": ".gem5"}
    for fmt in ("ramulator", "gem5"):
        for trial, bad in enumerate(_GARBAGE_LINES[fmt]):
            lines = list(good[fmt])
            at = int(rng.integers(0, len(lines) + 1))
            lines.insert(at, bad)
            path = str(tmp_path / f"{fmt}_{trial}{ext[fmt]}")
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            got = _raised(lambda: list(formats.PARSERS[fmt](path)))
            want = _raised(lambda: list(jformats.PARSERS[fmt](path)))
            assert isinstance(got, formats.TraceFormatError)
            assert isinstance(got, ValueError)
            assert (got.path, got.line, str(got)) == \
                (want.path, want.line, str(want)) == (path, at + 1, str(want))
            got = _raised(formats.load_trace, path)   # before any device
            assert str(got) == str(want)


def test_malformed_npz_traces_raise_as_jax(tmp_path):
    """Corrupt, truncated and wrong-keyed .npz files raise
    ``TraceFormatError`` naming the file, as JAX's loader does."""
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"\x13\x37 not a zip archive")
    wrong = tmp_path / "wrong.npz"
    np.savez(str(wrong), bank=np.zeros((2, 2), np.int32))
    whole = tmp_path / "ok.npz"
    formats.save_npz(str(whole), _trace(8, length=6)[1])
    blob = whole.read_bytes()
    paths = [garbage, wrong]
    for frac in (0.2, 0.6, 0.95):
        cut = tmp_path / f"cut_{frac}.npz"
        cut.write_bytes(blob[: int(len(blob) * frac)])
        paths.append(cut)
    for p in map(str, paths):
        got = _raised(formats.load_npz, p, CPU)
        want = _raised(jformats.load_npz, p)
        assert type(want) is jformats.TraceFormatError
        assert isinstance(got, formats.TraceFormatError), p
        assert (got.path, got.line) == (want.path, want.line) == (p, None)
        assert str(got).split(":")[0] == str(want).split(":")[0]
        assert isinstance(_raised(formats.load_trace, p),
                          formats.TraceFormatError)


# ------------------------------------------------------------------- source
def test_trace_source_rolling_window_trims():
    """The window keeps (spread + stage) columns, and staging stays
    position-exact after the trim, as JAX's source stages."""
    jtr = rand_trace(np.random.default_rng(1), 2, 64, 4, 16)
    src = source.TraceSource.from_chunks(source.chunk_iter(jtr, 8),
                                         prefetch=False)
    jsrc = jsource.TraceSource.from_chunks(jsource.chunk_iter(jtr, 8),
                                           prefetch=False)
    for pos in ([0, 0], [40, 42], [40, 42], [55, 62]):
        pos = np.array(pos)
        chunk, se = src.stage(pos, 4, CPU)
        jchunk, jse = jsrc.stage(pos, 4)
        _assert_traces_equal(chunk, jchunk, str(pos))
        np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
        assert (src.base, src._buf[0].shape[1]) == \
            (jsrc.base, jsrc._buf[0].shape[1])
    assert src.base == 55 and src._buf[0].shape[1] <= 24


def test_trace_source_stream_end_marks_tails():
    jtr, ttr = _trace(2)
    src, jsrc = source.TraceSource.from_trace(ttr), \
        jsource.TraceSource.from_trace(jtr)
    for pos, n in (([0, 8, 3], 4), ([9, 10, 6], 4), ([0, 0, 0], 10),
                   ([10, 10, 10], 3)):
        pos = np.array(pos)
        chunk, se = src.stage(pos, n, CPU)
        jchunk, jse = jsrc.stage(pos, n)
        _assert_traces_equal(chunk, jchunk, str(pos))
        np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
        assert src.exhausted(pos) == jsrc.exhausted(pos)
    _, se = src.stage(np.array([0, 8, 8]), 4, CPU)
    assert se.tolist() == [INT32_MAX, 2, 2]
    assert not src.exhausted(np.array([10, 9, 10]))
    assert src.exhausted(np.array([10, 10, 10]))


def test_trace_source_prefetch_propagates_ingest_errors():
    """A failed ingest fails the replay; the prefetch thread relays it."""
    def bad_chunks():
        yield _trace(0, length=4, n_cores=2)[1]
        raise ValueError("malformed line 17")

    src = source.TraceSource.from_chunks(bad_chunks(), prefetch=True)
    with pytest.raises(ValueError, match="malformed line 17"):
        src.stage(np.array([0, 0]), 64, CPU)


def _drain_source(src, n_cores, chunk_len=4):
    pos = np.zeros(n_cores, np.int64)
    out = []
    while not src.exhausted(pos):
        chunk, _ = src.stage(pos, chunk_len, CPU)
        out.append(chunk.bank.numpy())
        pos += chunk_len
    return out


@pytest.mark.parametrize("prefetch", [False, True])
def test_flaky_source_retries_then_streams_identically(prefetch):
    jtr, _ = _trace(11, length=20)
    chunks = list(source.chunk_iter(jtr, 4))
    src = source.TraceSource.from_chunks(
        _FlakyChunks(chunks, fail_on={1: 2, 3: 1}), prefetch=prefetch,
        retries=3, backoff=0.001)
    got = _drain_source(src, N_CORES)
    want = _drain_source(source.TraceSource.from_chunks(
        iter(chunks), prefetch=False), N_CORES)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefetch", [False, True])
def test_flaky_source_exhausted_retries_raises(prefetch):
    chunks = list(source.chunk_iter(_trace(12, length=12, n_cores=2)[0], 4))
    src = source.TraceSource.from_chunks(_FlakyChunks(chunks, {1: 99}),
                                         prefetch=prefetch, retries=2,
                                         backoff=0.001)
    with pytest.raises(OSError, match="transient read error at chunk 1"):
        _drain_source(src, 2)


def test_generator_sources_never_retry():
    chunk = _trace(13, length=4, n_cores=2)[1]

    def gen():
        yield chunk
        raise OSError("boom")

    it = gen()
    assert source._pull_retry(it, 5, 0.001) is chunk
    with pytest.raises(OSError, match="boom"):
        source._pull_retry(it, 5, 0.001)


def test_chunk_iter_yields_numpy_chunks():
    """The chunks a prefetch thread pulls are numpy arrays: it never
    touches a device."""
    jtr, ttr = _trace(14)
    got = list(source.chunk_iter(ttr, 4))
    want = list(jsource.chunk_iter(jtr, 4))
    assert len(got) == len(want) == 3
    for c, w in zip(got, want):
        assert all(isinstance(x, np.ndarray) for x in c)
        _assert_traces_equal(c, w)


# ----------------------------------------------------------------- profiler
def _assert_profiles_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(g, w, err_msg=f.name)
        assert np.asarray(g).dtype == np.asarray(w).dtype, f.name
    assert [dataclasses.astuple(b) for b in got.bands()] == \
        [dataclasses.astuple(b) for b in want.bands()]
    assert got.burstiness == want.burstiness
    assert got.write_frac == want.write_frac


@pytest.mark.parametrize("n_rows,window,chunk", [(128, 64, 17), (512, 256, 50)])
def test_profile_trace_matches_jax(n_rows, window, chunk):
    """Bands, histograms, burstiness and region priors equal JAX's, from
    the whole trace and from chunks."""
    from repro.sim import trace as jtrace
    from repro_torch.sim import trace as ttrace
    spec = dict(n_cores=8, length=200, n_banks=8, n_rows=n_rows, seed=1)
    jtr = jtrace.banded_trace(jtrace.TraceSpec(**spec))
    ttr = ttrace.banded_trace(ttrace.TraceSpec(**spec), device=CPU)
    want = jtraces.profile_trace(jtr, 8, n_rows, window=window)
    for got in (traces.profile_trace(ttr, 8, n_rows, window=window),
                traces.profile_trace(source.chunk_iter(ttr, chunk), 8, n_rows,
                                     window=window)):
        _assert_profiles_equal(got, want)
        assert len(got.bands()) >= 1
        for rs, k in ((13, 4), (6, None), (n_rows, 2)):
            nr = -(-n_rows // rs)
            np.testing.assert_array_equal(got.region_priors(rs, nr, k=k),
                                          want.region_priors(rs, nr, k=k))


# ------------------------------------------------------------ region priors
PRIORS = [[3, 5], [-1, 6, 2], [9, 1], [], [7, 6, 5, 4], [2]]


@pytest.mark.parametrize("n_slots_active", [INT32_MAX, 1])
@pytest.mark.parametrize("priors", PRIORS, ids=str)
def test_init_with_region_priors_matches_jax(priors, n_slots_active):
    """The warm start equals JAX's leaf by leaf: padding and out-of-range
    ids skipped, the slot budget respected, with and without tunables."""
    jt = jstate.make_tunables(select_period=8, n_slots_active=n_slots_active)
    tt = state.make_tunables(select_period=8, n_slots_active=n_slots_active)
    pri = np.asarray(priors, np.int32)
    for jtn, ttn in ((None, None), (jt, tt)):
        jst = JSYS.init(jtn, region_priors=pri)
        for given in (pri, torch.from_numpy(pri), list(priors)):
            assert_states_equal(jst, TSYS.init(ttn, region_priors=given),
                                f"{priors} tn={ttn is not None}")


def test_region_priors_ignored_at_full_coverage():
    jsys_, tsys_ = _systems(alpha=1.0)
    assert_states_equal(jsys_.init(region_priors=np.array([1, 2])),
                        tsys_.init(region_priors=np.array([1, 2])))


def test_primed_streamed_run_matches_jax():
    """Priors from the trace's own profile: the streamed run with them
    equals JAX's (windows included) and the primed single-shot run."""
    jtr, ttr = _trace(21)
    p = TSYS.p
    pri = traces.profile_trace(ttr, 8, N_ROWS, window=8).region_priors(
        p.region_size, p.n_regions, k=p.n_slots)
    jpri = jtraces.profile_trace(jtr, 8, N_ROWS, window=8).region_priors(
        p.region_size, p.n_regions, k=p.n_slots)
    np.testing.assert_array_equal(pri, jpri)
    assert (pri >= 0).all()
    single = JSYS.run(jtr, jsys.drain_bound(N_CORES, TLEN),
                      st=JSYS.init(region_priors=jpri))
    assert TSYS.run(ttr, system.drain_bound(N_CORES, TLEN),
                    st=TSYS.init(region_priors=pri)) == single
    got = traces.stream_replay(TSYS, ttr, chunk_len=3, region_priors=pri)
    want = jtraces.stream_replay(JSYS, jtr, chunk_len=3, region_priors=jpri)
    assert got == want
    assert traces.strip_windows(got) == single


# ------------------------------------------------------- the point axis
def test_stream_replay_points_raises():
    """``stream_replay_points`` is exported and runs a two-point batch on
    the CPU, equal to each point's own streamed replay (its JAX
    comparisons are in tests/test_torch_stream_points.py)."""
    from repro_torch.sweep import SweepPoint
    assert traces.stream_replay_points is stream.stream_replay_points
    pts = [SweepPoint(scheme="scheme_i", alpha=0.25, r=0.125, n_rows=N_ROWS,
                      n_cores=N_CORES, length=TLEN, select_period=8,
                      seed=s) for s in (0, 1)]
    trs = [_trace(s)[1] for s in (5, 6)]
    got = traces.stream_replay_points(pts, trs, chunk_len=4, device=CPU)
    assert got == [traces.stream_replay(TSYS, tr, chunk_len=4) for tr in trs]


def test_exports_match_jax():
    want = {n for n in dir(jtraces) if not n.startswith("_")
            and n not in ("formats", "profiler", "source", "stream")}
    got = {n for n in dir(traces) if not n.startswith("_")
           and n not in ("formats", "profiler", "source", "stream")}
    assert got == want


def test_default_devices_need_the_card():
    """Without a card, ``device=None`` raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = os.path.join(DATA, "tiny_ramulator.trace")
    npz = os.path.join(DATA, "tiny_trace.npz")
    for fn in (lambda: formats.load_trace(path),
               lambda: formats.load_npz(npz),
               lambda: formats.requests_to_trace([1, 2], [True, False]),
               lambda: source.TraceSource.from_trace(_trace(0)[1]).stage(
                   np.zeros(N_CORES, np.int64), 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    # stream_file needs no device: it yields host chunks
    assert isinstance(next(formats.stream_file(path, 2)).bank, np.ndarray)
