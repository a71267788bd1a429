"""The fused decoder's kernels against their roofline: the least time of the
decoder's work in the traced window (the entry's ``mlp`` part) over the
device time of the fused-MLP kernels; nothing where none ran (a decoder in
plain torch)."""


def read(ctx):
    part = ctx.work.get("mlp")
    seconds = ctx.trace.work_s(part["works"]) if part else 0.0
    return 100.0 * part["least_s"] * ctx.units / seconds if seconds > 0 else None
