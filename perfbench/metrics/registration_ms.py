"""Device time of the registration estimate, per call: the kernels launched
inside the program's ``df3d.register.estimate`` spans
(``Pipeline._register``: ``canonicalize.estimate_tc``, ``gain_correction``,
the repeats).  The note gives the launch calls and device operations a call
inside ``df3d.register.*``, and how much of the window's device work the
program's spans account for."""

import progspans


def read(ctx):
    p = progspans.of(ctx)
    if not p.calls or not p.kernels:
        return None
    ms = progspans.device_ms(p, p.kernels, lambda span, _: span == "df3d.register.estimate")
    note = "; ".join(f"{name}: " + progspans.launch_note(p, lambda span, name=name: span == name)
                     for name in ("df3d.register.copy", "df3d.register.estimate"))
    return ms, note + "; " + progspans.coverage_note(p)
