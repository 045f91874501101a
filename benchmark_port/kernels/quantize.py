"""The 16-level quantization's work: per call, one float32 tensor of the
defended batch's size read and one written.  ``TRACE_NAMES`` are the device
kernels that implement it today."""

TRACE_NAMES = ("quantize_kernel",)


def bytes_per_call(work) -> float | None:
    numel = work.get("defended_numel")
    return None if numel is None else 8.0 * numel
