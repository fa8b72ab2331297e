"""Device time of the undistortion, per call: the kernels launched inside the
program's ``df3d.undistort`` spans (``Pipeline._finish``:
``geometry._undistort_pixels``, the observations' pixels through the
calibration's fixed-point undistortion before the DLT; opened only where the
calibration has distortion).  The note gives the launch calls and device
operations a call inside it.  Nothing where no kernel was launched there."""

import progspans


def read(ctx):
    p = progspans.of(ctx)
    if not p.calls or not any(progspans.name_of(p, i) == "df3d.undistort"
                              for _, _, _, i in p.kernels):
        return None
    ms = progspans.device_ms(p, p.kernels, lambda span, _: span == "df3d.undistort")
    return ms, "df3d.undistort: " + progspans.launch_note(p, lambda span: span == "df3d.undistort")
