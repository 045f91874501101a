"""The PGD-L-inf update's work: per call, three float32 tensors of the
attacked batch's size read (the iterate, the gradient, the clean batch) and
one written, counted from the step's math whatever kernel implements it.
``TRACE_NAMES`` are the device kernels that implement it today."""

TRACE_NAMES = ("pgd_step_kernel",)


def bytes_per_call(work) -> float | None:
    numel = work.get("attack_numel")
    return None if numel is None else 16.0 * numel
