"""The join of the program's spans with a profiled window
(``bench/spans.py``): on a synthetic window, idle put down to spans and
``caller``, replays mapped onto a stage map, and a replay one event
short leaving the stage readings None, the device clock read from each
replay's launch lag; on the card, a traced stream window of a small
cell read end to end."""
import pytest

from bench import spans

#: two stages and the pseudo-stages: 1 + 2 + 1 device operations
STAGE_MAP = [("ingress", "ingress", 1), ("conv_1", "conv", 2),
             ("fc_2", "fc", 1), ("egress", "egress", 0)]


def _request(rid, t):
    """The four spans of request ``rid`` starting at ``t`` us: copy-in
    10 us, replay 5 us, clone-out 5 us."""
    call = {"name": "captured.call", "ts": t, "dur": 20.0,
            "args": {"rid": rid}}
    steps = [("captured.copy_in", t, 10.0), ("captured.replay", t + 10, 5.0),
             ("captured.clone_out", t + 15, 5.0)]
    return [call] + [{"name": n, "ts": s, "dur": d,
                      "args": {"rid": rid, "parent": "captured.call"}}
                     for n, s, d in steps]


def _window(short=False):
    """Two requests 100 us apart.  Each: a pageable copy (runtime call
    in its copy-in, device copy 4-9 us in), a graph launch in its replay
    (correlation 2 of the request), the graph's four events after it;
    the second request's last event left out where ``short``."""
    sp, host, device = [], [], []
    for rid, t in ((1, 1000.0), (2, 1100.0)):
        c = 10 * rid
        sp += _request(rid, t)
        host += [(t + 1, t + 9, "cudaMemcpyAsync", c + 1),
                 (t + 11, t + 14, "cudaGraphLaunch", c + 2)]
        device += [(t + 4, t + 9, "Memcpy HtoD (Pageable -> Device)", c + 1),
                   (t + 16, t + 18, "elementwise_kernel", c + 2),
                   (t + 18, t + 19, "pad_copy_kernel", c + 2),
                   (t + 19, t + 25, "void qconv_wgmma_kernel<128>", c + 2),
                   (t + 25, t + 30, "void qgemm_wgmma_kernel<64, 4>", c + 2)]
    if short:
        device.pop()
    return sp, device, host


def test_replays_map_onto_the_stage_map():
    sp, device, host = _window()
    j = spans.join(sp, device, host, STAGE_MAP)
    assert (j.mapped, j.replays, j.unmapped_why) == (2, 2, "")
    assert j.launches_in_replay == 2
    assert (j.copies_in_order, j.copies) == (2, 2)
    # device ms a forward of each stage, and of its non-conv events
    assert j.stages == [("ingress", "ingress", pytest.approx(0.002),
                         pytest.approx(0.002)),
                        ("conv_1", "conv", pytest.approx(0.007),
                         pytest.approx(0.001)),
                        ("fc_2", "fc", pytest.approx(0.005),
                         pytest.approx(0.005)),
                        ("egress", "egress", 0.0, 0.0)]
    assert j.stage_ms("ingress") == pytest.approx(0.002)
    assert j.stage_ms("conv", side=True) == pytest.approx(0.001)
    # the stages sum to the graph events' device time
    assert sum(ms for _, _, ms, _ in j.stages) * 2 * 1e-3 == \
        pytest.approx(j.graph_device_s)


def test_idle_is_put_down_to_the_innermost_span_or_the_caller():
    sp, device, host = _window()
    idle = spans.join(sp, device, host, STAGE_MAP).idle_by_span
    # in each request the gap 9-16 us in, whose middle lies in the
    # replay span; between the requests the gap from 30 us into the
    # first to 4 us into the second, whose middle lies in no span
    assert idle == pytest.approx({"captured.replay": 2 * 7e-6,
                                  "caller": 74e-6})


def test_a_replay_one_event_short_leaves_the_stage_readings_none():
    sp, device, host = _window(short=True)
    j = spans.join(sp, device, host, STAGE_MAP)
    assert (j.mapped, j.replays) == (1, 2)
    assert "request 2: 3 device events, the stage map holds 4" in \
        j.unmapped_why
    assert j.stage_ms("ingress") is None
    assert j.stage_ms("conv", side=True) is None


def test_a_replay_without_its_launch_is_unmapped():
    sp, device, host = _window()
    host = [h for h in host if h[3] != 22]
    j = spans.join(sp, device, host, STAGE_MAP)
    assert j.launches_in_replay == 1 and j.mapped == 1
    assert "0 graph launches" in j.unmapped_why
    assert j.stage_ms("ingress") is None


def test_the_device_clock_is_read_from_each_replays_launch_lag():
    sp, device, host = _window()
    j = spans.join(sp, device, host, STAGE_MAP)
    # each graph's first event 5 us after its launch starts
    assert (j.launch_lag_us, j.clock_drift_us) == (5.0, 0.0)
    # the device clock 3 us later by the second request, then 8 us ahead
    for shift, lag, drift in ((3.0, 5.0, 3.0), (-8.0, -3.0, -8.0)):
        moved = [(s + shift, e + shift, n, c) if c == 22 else (s, e, n, c)
                 for s, e, n, c in device]
        j = spans.join(sp, moved, host, STAGE_MAP)
        assert (j.launch_lag_us, j.clock_drift_us) == (lag, drift)
    assert spans.join([], [], [], STAGE_MAP).clock_drift_us is None


def test_span_medians_and_setup_seconds():
    sp = _request(1, 0.0) + _request(2, 50.0)
    sp[5]["dur"] = 30.0                       # request 2's copy-in
    assert spans.median_us(sp, "captured.copy_in") == 20.0
    assert spans.median_us(sp, "captured.replay") == 5.0
    assert spans.median_us(sp, "captured.none") is None
    setup = [{"name": "captured.capture", "dur": 2e6},
             {"name": "captured.capture", "dur": 5e5},
             {"name": "gate.quantize", "dur": 1.5e6}]
    assert spans.setup_seconds(setup, "captured.capture") == 2.5
    assert spans.setup_seconds(setup, "gate.quantize") == 1.5
    assert spans.setup_seconds(setup, "gate.parse") is None


@pytest.mark.cuda
def test_a_stream_window_on_the_card(cuda_device, tmp_path):
    """A small AlexNet's stream cell through windows 1-3: every reading
    is read, the replays map, and at least 99 % of the replay spans hold
    their request's graph launch."""
    from smallcells import bench_with
    from bench import cell
    from repro_torch.core import telemetry as tele

    bench = bench_with(tmp_path, "alexnet")
    _, config, traffic = cell.resolve(bench, "alexnet.stream_b1")
    s = cell.Setup(config, traffic, 2**31 + 5, cuda_device)
    (w1, w2, w3), sp2, sp3, device, host, captures = spans.windows(s, 0.3)
    assert w1.requests and w2.requests and w3.requests and captures == 0
    shape = tuple(s.pool[s.order[0]].shape)
    j = spans.join(sp3, device, host, s.executor.stage_map[shape])
    assert j.unmapped_why == "" and j.mapped == j.replays == w3.requests
    assert j.launches_in_replay >= 0.99 * j.replays
    assert j.copies_in_order == j.copies >= 0.99 * j.replays
    assert spans.median_us(sp2, "captured.copy_in") > 0
    assert spans.median_us(sp2, "captured.replay") > 0
    assert j.stage_ms("ingress") > 0 and j.stage_ms("conv", side=True) >= 0
    setup = tele.get_tracer().events()
    assert spans.setup_seconds(setup, "gate.quantize") > 0
    assert spans.setup_seconds(setup, "captured.capture") > 0
