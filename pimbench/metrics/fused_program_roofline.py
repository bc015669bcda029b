"""fused_program_roofline (%): the least time the card could take for the
window's admission windows (``roofline.fused_bound_s``) over the device
time of the ``fused_program`` kernels in the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.marked:
        return None
    t = run.trace.kernel_s("fused_program")
    return 100.0 * run.fused_bound_s() / t if t > 0 else None
