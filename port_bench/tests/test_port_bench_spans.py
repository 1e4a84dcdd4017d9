"""The readers of the program's phase spans, and the host's side of a
traced window (hostspans.py): the program's qvz.<phase> ranges, which
stay off the card's events, and the idle stretches named by them."""

from types import SimpleNamespace

import pytest

from port_bench import hostspans, run, trace

# each reader and the phase it reads
READERS = {"enc.parse_ms": "parse", "enc.container_ms": "container",
           "enc.jump_ms": "jump", "enc.design_serial_ms": "design_serial",
           "enc.warmup_wait_ms": "warmup_wait"}


def _window(phases_a, phases_b, op="encode"):
    work = dict(lines=10, columns=4, payload_bytes=100, text_bytes=50)
    return run.Window(op, [dict(phases=phases_a, work=work),
                           dict(phases=phases_b, work=work)])


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader(name):
    phase = READERS[name]
    got = run.reader(name).read(_window({phase: 0.25, "draws": 1.0},
                                        {phase: 0.75, "draws": 1.0}))
    assert got == pytest.approx(500.0)
    # a program without the phase (the parent) gives no reading
    assert run.reader(name).read(_window({"draws": 1.0},
                                         {"draws": 1.0})) is None
    assert run.reader(name).read(_window({phase: 0.25}, {phase: 0.75},
                                         op="decode")) is None


def _event(name, a, b, cuda=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


CARD = [_event("Memcpy HtoD (Pageable -> Device)", 10, 20, cuda=True),
        _event("void triples_kernel<0>()", 60, 70, cuda=True),
        _event("Memcpy DtoH (Device -> Pageable)", 75, 80, cuda=True),
        _event(run.WINDOW, 0, 100, cuda=True)]
HOST = [_event(run.WINDOW, 0, 100), _event("qvz.draws", 25, 58),
        _event("qvz.jump", 25, 35), _event("qvz.fill", 35, 58),
        _event("qvz.code", 60, 95), _event("qvz.container", 82, 95),
        _event("aten::copy_", 12, 18)]


def _prof(events):
    return SimpleNamespace(events=lambda: events)


def test_program_ranges_leave_the_card_s_events_alone():
    """The program's host ranges change no busy, idle or by-name figure."""
    alone = trace.device_events(_prof(CARD), 0, 100, skip=(run.WINDOW,))
    mixed = trace.device_events(_prof(CARD + HOST), 0, 100,
                                skip=(run.WINDOW,))
    assert mixed == alone and len(alone) == 3
    assert trace.busy_us(mixed) == trace.busy_us(alone) == 25
    assert trace.by_name(mixed) == trace.by_name(alone)
    assert trace.gaps(mixed, 0, 100) == trace.gaps(alone, 0, 100)


def test_host_ranges_nest():
    got = hostspans.host_ranges(_prof(CARD + HOST), 0, 90)
    assert got == [(25, 58, "draws", 0), (25, 35, "jump", 1),
                   (35, 58, "fill", 1), (60, 90, "code", 0),
                   (82, 90, "container", 1)]


def test_idle_stretches_are_trace_s_gaps():
    events = trace.device_events(_prof(CARD), 0, 100, skip=(run.WINDOW,))
    got = hostspans.idle(events, 0, 100)
    assert [(b - a, text) for a, b, text in got] == trace.gaps(events, 0,
                                                               100)
    assert [(a, b) for a, b, _ in got] == [(0, 10), (20, 60), (70, 75),
                                           (80, 100)]


def test_a_gap_under_jump_is_named_jump():
    ranges = hostspans.nest([(0, 100, "draws"), (10, 60, "jump"),
                             (60, 100, "fill")], 0, 100)
    # jump covers 40 of the 50, its parent all of it: the innermost wins
    assert hostspans.label(15, 65, ranges) == "jump"
    # none covers half: the one that covers most
    short = [(10, 20, "jump", 0), (30, 36, "fill", 0)]
    assert hostspans.label(0, 100, short) == "jump"
    assert hostspans.label(200, 300, ranges) == "none"
    assert hostspans.self_us(5, 65, ranges) == {"draws": 5, "jump": 50,
                                               "fill": 5}


def test_named_gaps_and_coverage():
    prof = _prof(CARD + HOST)
    events = trace.device_events(prof, 0, 100, skip=(run.WINDOW,))
    ranges = hostspans.host_ranges(prof, 0, 100)
    stretches = hostspans.idle(events, 0, 100)
    gaps = hostspans.named_gaps(stretches, ranges, top=2)
    assert gaps[0] == (40, "after copy to card, before K2a triples; "
                       "host: fill", {"fill": 23, "jump": 10, "none": 7})
    assert gaps[1] == (20, "after copy to host, before window end; "
                       "host: container", {"container": 13, "none": 5,
                                           "code": 2})
    # 75 us idle: 33 + 5 + 15 of it under a range
    assert hostspans.covered_us(stretches, ranges) == 53
    assert hostspans.idle_by_phase(stretches, ranges) == {
        "none": 22, "fill": 23, "jump": 10, "code": 7, "container": 13}
