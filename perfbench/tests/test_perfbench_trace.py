"""The reading of a traced sub-window, on hand-made events."""

from __future__ import annotations

from perfbench.lib.trace import WINDOW_RANGE, Event, device_totals, read_events

MS = 1_000_000  # ns


def test_busy_union_ops_and_idle_gaps():
    events = [
        Event(WINDOW_RANGE, False, 0, 10 * MS, "user_annotation"),
        Event("pb.frame", False, 0, 6 * MS, "user_annotation"),
        Event("pb.decode", False, 6 * MS, 10 * MS, "user_annotation"),
        # a range's device twin and a step marker: no device work
        Event("pb.frame", True, 0, 6 * MS, "gpu_user_annotation"),
        Event("ProfilerStep#1", True, 0, 10 * MS, "kernel"),
        # two kernels overlapping, one copy, one op past the window
        Event("conv2d_igemm_kernel<float>", True, 1 * MS, 3 * MS, "kernel"),
        Event("conv2d_igemm_kernel<float>", True, 2 * MS, 4 * MS, "kernel"),
        Event("Memcpy DtoH", True, 7 * MS, 8 * MS, "gpu_memcpy"),
        Event("late", True, 9 * MS, 12 * MS, "kernel"),
    ]
    t = read_events(events, 0.010)
    assert t.window_s == 0.010
    assert abs(t.busy_s - 0.005) < 1e-12  # [1, 4] + [7, 8] + [9, 10] ms
    assert t.op_seconds("conv2d_igemm_kernel") == (0.004, 2)
    assert "pb.frame" not in t.ops and "ProfilerStep#1" not in t.ops
    gaps = dict((k, round(v, 9)) for k, v in t.breakdown()["idle_gaps"])
    # idle [0, 1] and [4, 7] ms have their middles in pb.frame, [8, 9] in
    # pb.decode
    assert gaps == {"pb.frame": 0.004, "pb.decode": 0.001}
    ops = t.breakdown()["device_ops"]
    assert ops[0][0].startswith("conv2d_igemm_kernel") and len(ops) == 3


def test_whole_window_device_totals():
    events = [
        # a CUDA call on the host, a range's device twin, a step marker
        Event("cudaLaunchKernel", False, 0, 1 * MS, "cuda_runtime"),
        Event("pb.frame", True, 0, 6 * MS, "gpu_user_annotation"),
        Event("ProfilerStep#1", True, 0, 10 * MS, "kernel"),
        Event("conv2d_igemm_kernel<float>", True, 1 * MS, 3 * MS, "kernel"),
        Event("conv2d_igemm_kernel<float>", True, 2 * MS, 4 * MS, "kernel"),
        Event("Memcpy HtoD (Pageable -> Device)", True, 5 * MS, 6 * MS,
              "gpu_memcpy"),
        Event("Memset (Device)", True, 6 * MS, 7 * MS, "gpu_memset"),
    ]
    d = device_totals(events)
    assert abs(d.busy_s - 0.005) < 1e-12  # [1, 4] + [5, 7] ms
    assert abs(d.kernel_s - 0.004) < 1e-12
    assert abs(d.copy_s - 0.002) < 1e-12
    assert d.n_ops == 4
