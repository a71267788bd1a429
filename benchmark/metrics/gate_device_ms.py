"""Device milliseconds a step outside the products, the hash encoder's
kernels and the optimizer: every device operation of the traced steps
whose kind of work (``kernels/``) is none of the entry's
``gate["not_works"]``, over the steps traced. On the hash SIREN's step that
is the sine-layer pair, the gates' products and their gradients, the
modulator's bias adds, ReLUs and concatenations and theirs, the bias
gradients' sums, the latent gradient's sum, the loss and its gradient, the
table gradient's zero fill, and the epoch's shuffle, batch gather and loss
copy. Nothing where the entry names no such part."""


def read(ctx):
    part = ctx.work.get("gate")
    if not part or not ctx.units:
        return None
    seconds = sum(dur for name, _, dur in ctx.trace.ops if ctx.trace.work_of(name) not in part["not_works"])
    return 1e3 * seconds / ctx.units if seconds > 0 else None
