"""The conv2d kernel's share of its roofline over the traced sub-window:
the least time of its launches (the larger of FLOPs / 67 TFLOP/s f32 and
bytes / 3.35 TB/s, each launch's from its shapes) over their device time.

A call launches the kernel once a layer in the streamed pass and once a
layer in the executor's sparsity pass, on the same shapes, so the
launches come in whole calls of the configuration's layers. The trace's
count of launches has to equal the port's own (``CudaLibrary.launches``
over the same sub-window): a trace that dropped a launch reads nothing."""

from perfbench.counts import cnn, peaks

SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "device_us_per_frame"
KERNEL = "conv2d_igemm_kernel"


def read(r: dict):
    trace = r.get("trace")
    if trace is None:
        return None
    kernel_s, n = trace.op_seconds(KERNEL)
    counts = cnn.launch_counts(r["config"], r["batch"])
    if n == 0 or n % len(counts) or n != r.get("sub_conv_launches"):
        return None
    least = sum(peaks.least_s(f, b, peaks.F32_FLOPS) for f, b in counts)
    return 100.0 * least * (n // len(counts)) / kernel_s
