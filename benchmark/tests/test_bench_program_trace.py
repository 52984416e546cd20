"""The device's idle time split over the program's spans
(``benchmark/program_trace.py``), on synthetic events and spans."""

import types

import pytest

from benchmark import program_trace as pt

us = 1000


def record(spans, counters=None):
    """A recorder's ``Record`` of ``[(name, start, end, parent, frame)]``."""
    return types.SimpleNamespace(
        names=[s[0] for s in spans], start_ns=[s[1] for s in spans],
        end_ns=[s[2] for s in spans], parent=[s[3] for s in spans],
        frame=[s[4] for s in spans], counters=counters or {})


def events():
    return [
        ("spin_kernel", 0 * us, 1 * us),            # step
        ("sort_kernel", 20 * us, 25 * us),
        ("block_pairs_kernel", 40 * us, 50 * us),
        ("grid_euler_substep_kernel", 50 * us, 55 * us),
        ("spin_kernel", 60 * us, 61 * us),          # normals
        ("gather_kernel", 80 * us, 85 * us),
    ]


def test_idle_intervals_leave_the_markers_out():
    assert pt.idle_intervals(events()) == [
        (0, 20 * us), (25 * us, 40 * us), (55 * us, 80 * us)]
    assert pt.idle_intervals([("k", 0, 5)]) == []


def test_a_gap_split_over_two_spans():
    # the host in the sort from 2 to 22 us, in the partner search from 22
    # to 38: the gap 0-20 is 2 us the loop's (before any span), 18 the
    # sort's; the gap 25-40 is 13 us the partner search's, 2 the loop's
    rec = record([("blocksparse.sort", 2 * us, 22 * us, -1, 1),
                  ("blocksparse.partners", 22 * us, 38 * us, -1, 1)])
    by_span, by_loop = pt.attribute(events(), rec, ["step", "normals"],
                                    [0, 58 * us])
    assert by_span == {0: 18 * us, 1: 13 * us}
    assert by_loop == {"step": 2 * us + 2 * us + 3 * us,
                       "normals": 22 * us}


def test_a_gap_under_no_span_goes_to_the_loop():
    rec = record([])
    by_span, by_loop = pt.attribute(events(), rec, ["step", "normals"],
                                    [0, 58 * us])
    assert by_span == {}
    assert by_loop == {"step": 20 * us + 15 * us + 3 * us,
                       "normals": 22 * us}


def test_the_innermost_span_takes_the_idle_and_the_parent_its_self_part():
    rec = record([("api.step", 0, 57 * us, -1, 1),
                  ("selfcollide", 10 * us, 45 * us, 0, 1),
                  ("blocks.launch", 30 * us, 45 * us, 1, 1),
                  ("api.normals", 58 * us, 86 * us, -1, 1),
                  ("normals.sum", 70 * us, 84 * us, 3, 1)])
    by_span, by_loop = pt.attribute(events(), rec, ["step", "normals"],
                                    [0, 58 * us])
    assert by_span == {0: 10 * us + 2 * us, 1: 10 * us + 5 * us,
                       2: 10 * us, 3: 12 * us, 4: 10 * us}
    assert by_loop == {"step": 1 * us}      # 57-58: between the two roots
    assert pt.under(rec, by_span, "selfcollide") == 25 * us
    assert pt.under(rec, by_span, "api.step") == 37 * us
    assert pt.under(rec, by_span, "api.normals") == 22 * us
    assert pt.by_name(rec, by_span)["api.step"] == 12 * us
    top = pt.idle_by_program_span(rec, by_span, by_loop)
    assert top[0] == ["selfcollide", pytest.approx(15e-6)]
    assert [name for name, _ in top] == [
        "selfcollide", "api.step", "api.normals", "blocks.launch",
        "normals.sum", "step"]


def test_innermost_segments_of_nested_spans():
    segs = pt.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                         (5, 6, "d"), (12, 13, "e")])
    assert segs == [(0, 2, "a"), (2, 4, "b"), (4, 5, "c"), (5, 6, "d"),
                    (6, 10, "a"), (12, 13, "e")]


def test_marker_lags_and_an_offset_between_the_clocks():
    noted = [-4 * us, 57 * us]
    assert pt.marker_lags(events(), noted) == [4 * us, 3 * us]
    assert pt.marker_lags(events(), noted[:1]) == []
    assert pt.lag_summary([4 * us, 3 * us, 5 * us]) == {
        "min_us": 3.0, "median_us": 4.0, "max_us": 5.0}
    # markers start 10 us after their notes: the idle 0-20 and 25-40 us on
    # the device's clock are the host's -10-10 and 15-30, 5 + 10 us of them
    # while the host sorted (5-25)
    rec = record([("blocksparse.sort", 5 * us, 25 * us, -1, 1)])
    offsets = pt.clock_offsets(events(), [-10 * us, 50 * us])
    assert offsets == ([0, 60 * us], [10 * us, 10 * us])
    by_span, _ = pt.attribute(events(), rec, ["step", "normals"],
                              [-10 * us, 50 * us], offsets)
    assert by_span == {0: 15 * us}


def test_clock_offsets_follow_a_drifting_clock():
    """Markers 1 s apart whose lag drifts by 10 us a marker, with every
    third one queued behind 500 us of work: each offset is the least lag
    within the window, so it follows the drift and skips the queued."""
    noted = [k * 10**9 for k in range(9)]
    lags = [5 * us - 10 * us * k + (500 * us if k % 3 == 1 else 0)
            for k in range(9)]
    evs = [("spin_kernel", t + lag, t + lag + 1) for t, lag in
           zip(noted, lags)]
    starts, off = pt.clock_offsets(evs, noted, window_ns=10**9)
    assert starts == [e[1] for e in evs]
    assert off == [min(x for k, x in enumerate(lags) if abs(k - j) <= 1)
                   for j in range(9)]
    assert off[1] == lags[2] and off[4] == lags[5]
    assert pt.clock_offsets(evs[:-1], noted) is None
    # an interval after marker 4 moves by marker 4's offset
    assert pt.to_host_clock([(starts[4] + 7, starts[4] + 9)],
                            (starts, off)) == [
        (starts[4] + 7 - off[4], starts[4] + 9 - off[4])]


def test_program_metrics():
    # frame 1 profiled (from 0 to 100 us), frames 2 and 3 not
    spans = []
    for f, t in ((1, 0), (2, 200 * us), (3, 400 * us)):
        root = len(spans)
        spans += [("api.step", t, t + 100 * us, -1, f),
                  ("api.lookup", t + 1 * us, t + 3 * us, root, f),
                  ("grid_euler.planes_in", t + 3 * us, t + 6 * us, root, f),
                  ("selfcollide", t + 10 * us, t + 40 * us, root, f),
                  ("blocks.launch", t + 30 * us, t + 40 * us, root + 3, f),
                  ("grid_euler.call", t + 40 * us, t + 90 * us, root, f),
                  ("api.normals", t + 100 * us, t + 110 * us, -1, f)]
    rec = record(spans, {"block_pairs.pairs_swept": 4096,
                         "block_pairs.pairs_in_reach": 1024})
    by_span = {3: 6 * us, 4: 4 * us, 6: 5 * us}
    m = pt.program_metrics(rec, by_span, (0, 150 * us), substeps=2,
                           frames=1)
    # api.step self: 100 - 2 - 3 - 30 - 50 = 15 us, + lookup and planes in
    assert m["wrapper_host_us"] == pytest.approx(15 + 2 + 3)
    assert m["selfcollide_host_us"] == pytest.approx(30)
    assert m["selfcollide_idle_us"] == pytest.approx(10 / 2)
    assert m["normals_idle_us"] == pytest.approx(5)
    assert m["pair_hit_pct"] == pytest.approx(25.0)
    empty = pt.program_metrics(record([]), {}, (0, 1), 0, 0)
    assert set(empty.values()) == {None}
