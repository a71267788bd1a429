"""Device milliseconds a step outside the products and the optimizer: every
device operation of the traced steps whose kind of work (``kernels/``) is
none of the entry's ``gabor["not_works"]`` (the linear layers' products and
Adam), over the steps traced. On WIRE's full-batch step that is the complex
Gabor activations and their gradients, the bias adds and the bias
gradients' sums, the loss and its gradient, and the epoch's shuffle, batch
gather and loss copy. Nothing where the entry names no such part."""


def read(ctx):
    part = ctx.work.get("gabor")
    if not part or not ctx.units:
        return None
    seconds = sum(dur for name, _, dur in ctx.trace.ops if ctx.trace.work_of(name) not in part["not_works"])
    return 1e3 * seconds / ctx.units if seconds > 0 else None
