"""The metric arithmetic: chunk completions and their 95th percentile, the
union of device intervals and the idle gaps, the roofline share, and each
reader leaving out what it finds nothing for."""

import numpy as np
import pytest

from portbench.harness.common import bound_s, load_reader
from portbench.harness.trace import breakdown, kernel_class, summarize, union
from portbench.harness.video import ChunkClock, WindowClosed


def test_chunk_clock_stamps_chunk_ends_and_closes():
    clock = ChunkClock(2)
    clock.start_video(0, 5)
    for i in range(5):
        clock.write_log(f"> v0-{i} PSNR=1")
    clock.write_log("not a frame line")
    assert len(clock.chunks) == 3                   # 2 + 2 + the last 1
    assert [f[2] for f in clock.frames] == [0, 1, 2, 3, 4]
    assert clock.frames[0][0] == clock.frames[1][0] == clock.chunks[0]
    clock.deadline = 0.0
    clock.start_video(1, 2)
    clock.write_log("> a")
    with pytest.raises(WindowClosed):
        clock.write_log("> b")


def test_p95_of_chunk_gaps():
    t0, done = 10.0, [10.1 * 1.0 + 0.1 * k for k in range(100)]
    gaps = np.diff([t0] + done) * 1e3
    assert abs(np.percentile(gaps, 95) - 100.0) < 1e-6


def test_union_and_idle():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    # host clock h (s) = trace clock (us) / 1e6 - 1; the start marker at 0,
    # the end marker (the longer spin) from 80 to 100
    ev = [k("at::cuda::spin_kernel(long)", 1e6 + 0, 1), k("at::cuda::spin_kernel(long)", 1e6 + 80, 20),
          k("void swin_block_kernel<1>(int)", 1e6 + 10, 20), k("ampere_bf16_gemm", 1e6 + 20, 20),
          k("elementwise_kernel", 1e6 + 200, 20)]
    spans = [("restore", 0.0, 50e-6, True), ("legs", 55e-6, 58e-6, True),
             ("next_batch", 0.0, 100e-6, False)]
    s = summarize(ev, 0.0, 80e-6, spans)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    # gaps 0-10 (inside the restore span) and 40-100 (its middle after legs)
    assert s["idle_by_host"] == pytest.approx({"restore": 10e-6, "after legs": 60e-6})
    assert s["device_by_class"] == pytest.approx({"port kernels": 20e-6, "matmuls": 20e-6})
    bd = breakdown(s)
    assert {bd["device_ops"][0][0], bd["device_ops"][1][0]} == {"swin_block_kernel",
                                                                "ampere_bf16_gemm"}
    assert kernel_class("void at::native::vectorized_elementwise_kernel") == "elementwise"


def test_k2_roofline_share():
    read = load_reader("k2_roofline.video").read
    k2 = {"tokens": 1000, "flops_per_token": 1e6, "stream_bytes_per_token": 10,
          "weight_bytes": 0}
    least = bound_s(1e9, 1e4)
    ctx = {"kind": "video", "launches": {"swin_block": 4}, "k2_launch": k2,
           "bound_s": bound_s,
           "trace": {"device_by_name": {"void swin_block_kernel<2>": 8 * least}}}
    assert read(ctx) == pytest.approx(50.0)
    ctx["launches"] = {"swin_block": 0}
    assert read(ctx) is None
    assert read({"kind": "train"}) is None


def test_readers_leave_out_other_kinds():
    import glob
    import os

    from portbench.harness.common import HERE

    for path in glob.glob(str(HERE / "metrics" / "*.py")):
        name = os.path.basename(path)[:-3]
        other = "train" if name.endswith(".video") else "video"
        assert load_reader(name).read({"kind": other}) is None, name


@pytest.mark.parametrize("kept", ["start", "end"])
def test_summarize_ties_the_clocks_by_either_marker(kept):
    """The profiler may drop one marker's record; the other, told by its
    length, ties the clocks and the stretch keeps its ends."""
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    marks = {"start": k("at::cuda::spin_kernel(long)", 1e6 + 0, 1),
             "end": k("at::cuda::spin_kernel(long)", 1e6 + 80, 20)}
    ev = [marks[kept], k("void swin_block_kernel<1>(int)", 1e6 + 10, 20)]
    s = summarize(ev, 0.0, 80e-6, [("restore", 0.0, 50e-6, True)])
    assert s["window_s"] == pytest.approx(100e-6 if kept == "end" else 80e-6)
    assert s["busy_s"] == pytest.approx(20e-6)
    assert s["idle_by_host"]["restore"] == pytest.approx(10e-6)


def test_summarize_refuses_a_trace_without_its_markers():
    """Device events whose clock cannot be tied to the host's are refused,
    not placed by guess."""
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    ev = [k("elementwise_kernel", 10, 20), k("ampere_bf16_gemm", 40, 20)]
    with pytest.raises(RuntimeError, match="marker"):
        summarize(ev, 0.0, 99e-6, [])
