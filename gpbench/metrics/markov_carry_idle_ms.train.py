"""Device idle ms a training step in the program slice given to the Markov
scan's cross-chunk carries: the idle time of the ``ops.markov.carry``
spans (``gpbench.spans``), the host's loop of combines one after another,
over the slice's ``fit.step`` units. None where no such span was recorded
(a port without it, or another path). Autograd's backward of the loop runs
under ``fit.backward``, not under this span."""

from gpbench import spans

SPAN = "ops.markov.carry"


def read(rec):
    sl = spans.program_slice(rec)
    if sl is None or sl.root != "fit.step" or not sl.units or SPAN not in sl.idle_by_name:
        return None
    return sl.idle_by_name[SPAN] / sl.units / 1e6
