"""Device idle in registration, per call: the time no kernel runs (a copy is
not work, as ``device_idle_pct`` counts it) while the host's innermost
program span is ``df3d.register.copy`` or ``df3d.register.estimate``.  The
note gives the window's whole idle sweep, ms a call by the innermost program
span the host was in (the benchmark's span where no program span holds it)."""

import progspans


def read(ctx):
    p = progspans.of(ctx)
    if not p.calls or not ctx.trace.kernels:
        return None
    idle = progspans.idle_by_span(p, ctx.trace)
    ms = sum(v for k, v in idle.items() if k.startswith("df3d.register.")) / p.calls * 1e-6
    sweep = {k: round(v / p.calls * 1e-6, 4)
             for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}
    return ms, f"idle ms a call by span: {sweep}"
