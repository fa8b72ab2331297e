"""Device time after the network, per call: the kernels launched inside the
program's ``df3d.decode``, ``df3d.assemble`` and ``df3d.triangulate`` spans
(``decode.cu``, ``assemble38`` and the confidence layout,
``geometry.triangulate(method="normal")``, ``adjust_points38``).  The note
gives the launch calls and device operations a call inside each."""

import progspans

TAIL = ("df3d.decode", "df3d.assemble", "df3d.triangulate")


def read(ctx):
    p = progspans.of(ctx)
    if not p.calls or not p.kernels:
        return None
    ms = progspans.device_ms(p, p.kernels, lambda span, _: span in TAIL)
    note = "; ".join(f"{name}: " + progspans.launch_note(p, lambda span, name=name: span == name)
                     for name in TAIL)
    return ms, note
