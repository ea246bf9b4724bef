"""Cross-chunk combines a training step in the program slice that the
Markov scan made one after another on the host: the library-call counter
``markov_carry_combine`` (``models/markov.py``) summed over the slice's
``fit.step`` spans, over their number. None where the port has no such
counter."""

from gpbench import spans


def read(rec):
    from abstractgps_tpu_torch.utils import profiling

    sl = spans.program_slice(rec)
    if (sl is None or sl.root != "fit.step" or not sl.units
            or "markov_carry_combine" not in profiling.LIBRARY_CALLS):
        return None
    return sl.counts.get("library.markov_carry_combine", 0) / sl.units
