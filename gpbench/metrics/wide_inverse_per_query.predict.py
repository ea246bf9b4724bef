"""Triangular inverses of the training factor a query in the program slice:
the library-call counter ``wide_inverse`` (``blocked_chol._wide_inverse``)
summed over the slice's ``posterior.mean_and_var`` spans, over their
number. Each is work on a factor that did not change since set-up."""

from gpbench import spans


def read(rec):
    sl = spans.program_slice(rec)
    if sl is None or sl.root != "posterior.mean_and_var" or not sl.units:
        return None
    return sl.counts.get("library.wide_inverse", 0) / sl.units
