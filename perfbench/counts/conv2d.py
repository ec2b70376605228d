"""One launch of the port's conv2d kernel (SAME, stride 1, bias and ReLU
fused): the operations and the bytes it needs, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever the kernel reads again; the bias add and the ReLU are one
operation each an output."""

from __future__ import annotations


def flops(b: int, h: int, w: int, cin: int, cout: int, k: int = 3) -> int:
    return 2 * b * h * w * cin * cout * k * k + 2 * b * h * w * cout


def nbytes(b: int, h: int, w: int, cin: int, cout: int, k: int = 3,
           itemsize: int = 4) -> int:
    x = b * h * w * cin
    wt = k * k * cin * cout
    y = b * h * w * cout
    return (x + wt + cout + y) * itemsize
