"""Matvecs a training step in the program slice that the CG solver ran
after every column of its batch had frozen: the library-call counter
``cg_converged_matvec`` (``iterative.mbcg``) summed over the slice's
``fit.step`` spans, over their number. None where the port has no such
counter."""

from gpbench import spans


def read(rec):
    from abstractgps_tpu_torch.utils import profiling

    sl = spans.program_slice(rec)
    if (sl is None or sl.root != "fit.step" or not sl.units
            or "cg_converged_matvec" not in profiling.LIBRARY_CALLS):
        return None
    return sl.counts.get("library.cg_converged_matvec", 0) / sl.units
