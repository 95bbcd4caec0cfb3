"""The spans stretch's reduction (``benchmark/spans.py``) on synthetic
profiler events, its five readers, and, on the card (``-m cuda``), that
the program's spans and the profiler's events share one clock."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import core, spans

# thread keys of two threads; times in ns
T1, T2 = 7, 9
SPANS = [  # (index, name, start, end, parent, thread)
    (0, "caption", 100, 1000, -1, T1),
    (1, "encode", 110, 300, 0, T1),
    (2, "decode.pick", 400, 600, 0, T1),
    (3, "other", 50, 2000, -1, T2),
    (4, "caption", 1200, 1500, -1, T1),
]


def _op(start, end, corr):
    return (start, end, corr, f"kernel{corr}")


def _call(start, corr, thread=T1, name="cudaLaunchKernel"):
    return (start, start + 5, corr, name, thread)


def test_a_kernel_goes_to_the_innermost_span_open_at_its_launch():
    ops = [_op(700, 750, 1),      # launched inside encode, ran after it closed
           _op(760, 800, 2),      # launched inside decode.pick
           _op(810, 820, 3),      # launched in caption, between its children
           _op(830, 840, 4),      # launched on the other thread
           _op(850, 860, 5),      # launched after every span of its thread
           _op(870, 880, 6)]      # no launch call recorded
    calls = [_call(200, 1), _call(205, 1, name="Runtime Triggered Module Loading"),
             _call(450, 2), _call(350, 3), _call(120, 4, thread=T2), _call(1600, 5)]
    got = spans.reduce(SPANS, ops, calls, 100, 1500)
    assert got["device_ns"] == {("caption", "encode"): 50, ("caption", "decode.pick"): 40,
                                ("caption",): 10, ("other",): 10, (): 20}
    assert got["launches"] == {("caption", "encode"): 1, ("caption", "decode.pick"): 1,
                               ("caption",): 1, ("other",): 1, (): 1}
    assert spans.under(got["device_ns"], ["caption"]) == 100
    assert spans.under(got["device_ns"], ["encode", "decode.pick"]) == 90
    assert spans.by_innermost(got["device_ns"]) == {
        "encode": 50, "decode.pick": 40, "caption": 10, "other": 10, spans.OUTSIDE: 20}


def test_an_idle_gap_goes_to_the_span_open_at_its_midpoint():
    one_thread = [s for s in SPANS if s[5] == T1]
    ops = [_op(150, 250, 1), _op(300, 420, 2), _op(1100, 1150, 3)]
    got = spans.reduce(one_thread, ops, [], 100, 1600)
    # gaps: 100-150 (mid 125: encode), 250-300 (275: encode), 420-1100 (760:
    # caption), 1150-1600 (1375: the second caption)
    assert got["busy_ns"] == 100 + 120 + 50 and got["window_ns"] == 1500
    assert got["idle_ns"] == {("caption", "encode"): 100, ("caption",): 680 + 450}
    # idle while a caption is open: 100-150, 250-300, 420-1000, 1200-1500
    assert got["program_idle_ns"] == 50 + 50 + 580 + 300
    got = spans.reduce(one_thread, ops, [], 0, 1600)
    # 0-150 has its midpoint at 75, before any span: outside the program
    assert got["idle_ns"][()] == 150 and got["program_idle_ns"] == 980


def test_per_request_divides_by_the_caption_spans():
    got = spans.reduce(SPANS, [_op(700, 760, 1)], [_call(200, 1)], 100, 1500)
    assert got["requests"] == 2
    ctx = SimpleNamespace(spans=got)
    assert spans.device_ms(ctx, ["encode"]) == 60 / 1e6 / 2


def test_the_thread_key_is_the_runtime_event_s():
    """Two threads' ``threading.get_ident()`` and the ``device_resource_id``
    of their runtime events, read from the profiler on the card."""
    assert spans.thread_key(140521243030272) == -1496960256
    assert spans.thread_key(140506558363328) == 998241984


NEW = ("encode_ms.serve", "decode_cell_ms.serve", "decode_pick_ms.serve",
       "decode_reorder_ms.serve", "program_idle_pct.serve")


def test_the_five_readers():
    rows = SPANS[:3] + [(5, "prime", 320, 380, 0, T1), (6, "decode.cell", 390, 399, 0, T1),
                        (7, "decode.reorder", 610, 690, 0, T1)]
    ops = [_op(400, 410, 1), _op(420, 450, 2), _op(460, 500, 3), _op(510, 530, 4),
           _op(540, 560, 5)]
    calls = [_call(200, 1), _call(330, 2), _call(395, 3), _call(500, 4), _call(650, 5)]
    ctx = SimpleNamespace(spans=spans.reduce(rows, ops, calls, 100, 1100))
    got = {m: core.metric_reader(m).read(ctx) for m in NEW}
    assert got == {"encode_ms.serve": 40 / 1e6, "decode_cell_ms.serve": 40 / 1e6,
                   "decode_pick_ms.serve": 20 / 1e6, "decode_reorder_ms.serve": 20 / 1e6,
                   # idle in the caption (100-1000): 100-400, four 10 ns gaps,
                   # 560-1000
                   "program_idle_pct.serve": 100.0 * 780 / 1000}
    silent = SimpleNamespace(spans=None)
    assert all(core.metric_reader(m).read(silent) is None for m in NEW)


def test_no_stretch_on_the_cpu_or_for_a_program_without_the_recorder(monkeypatch):
    logged = []
    ctx = SimpleNamespace(trace=True, profile={"requests": 1}, device=torch.device("cpu"),
                          log=logged.append)
    assert spans.measure(ctx) is None
    from vcr_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    ctx.device = torch.device("cuda", 0)
    assert spans.measure(ctx) is None and "records no spans" in logged[-1]


@pytest.mark.cuda
def test_a_span_encloses_the_profiler_s_runtime_event(card):
    """One clock: a span around a synchronise encloses the profiler's
    ``cudaDeviceSynchronize`` of the same thread, to the nanosecond."""
    from torch.profiler import ProfilerActivity, profile

    from vcr_tpu_torch.utils.profiling import recording, span

    x = torch.randn(1024, 1024, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, recording() as rec:
        for _ in range(3):
            x = x @ x
            with span("sync"):
                torch.cuda.synchronize(card)
            time.sleep(0.01)
    ops, calls = spans.kineto_events(prof)
    syncs = [c for c in calls if c[3] == "cudaDeviceSynchronize"]
    marks = [s for s in rec.closed() if s.name == "sync"]
    assert len(marks) == 3 and ops
    for s in marks:     # the profiler may synchronise too, outside the spans
        inside = [c for c in syncs if s.start_ns <= c[0] <= c[1] <= s.end_ns]
        assert len(inside) == 1 and inside[0][4] == spans.thread_key(s.thread)


def test_the_stretch_finds_the_cell_s_driver(small):
    base, bench = small
    contexts = [core.build_context("s2vt.beam5.b512", seed, 0.1, False, torch.device("cpu"),
                                   bench=bench, base=base) for seed in (5, 6)]
    drivers = [ctx.driver_module.Driver(ctx) for ctx in contexts]
    assert [spans.cell_driver(ctx) for ctx in contexts] == drivers
