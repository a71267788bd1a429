"""Device milliseconds a step outside the products and the optimizer: every
device operation of the traced epoch whose kind of work (``kernels/``) is
none of the entry's ``psf["not_works"]`` (the linear layers' products and
Adam), over the steps traced. On the PSF SIREN's step that is the
expansion, the w0 scaling and the sines, the loss, their gradients and the
bias gradients' sums, and the epoch's one shuffle and loss copy; the
integration's weighted sum (an einsum, which runs as a batched cuBLAS
product) and its gradient fall among the products, at about 2 MB a step.
Nothing where the entry names no such part."""


def read(ctx):
    part = ctx.work.get("psf")
    if not part or not ctx.units:
        return None
    seconds = sum(dur for name, _, dur in ctx.trace.ops if ctx.trace.work_of(name) not in part["not_works"])
    return 1e3 * seconds / ctx.units if seconds > 0 else None
