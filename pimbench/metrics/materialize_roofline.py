"""materialize_roofline (%): the least time the card could take for the
end-to-end queries' materialize launches (``roofline.materialize_bound_s``)
over the device time of the ``materialize`` kernels in the trace."""


def read(run):
    if run.trace is None or not run.trace.marked:
        return None
    t = run.trace.kernel_s("materialize")
    return 100.0 * run.materialize_bound_s() / t if t > 0 else None
