"""Device time of the copies from pinned host memory to the device (the
frames' staging in ``Pipeline._register``), per call of the traced window;
nothing where the frames start on the device."""


def read(ctx):
    copies = [e - s for n, s, e in ctx.trace.copies if n.startswith("Memcpy HtoD (Pinned")]
    if not copies or not ctx.trace.calls:
        return None
    return sum(copies) / ctx.trace.calls * 1e-6
