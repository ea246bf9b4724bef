"""Device idle ms a training step in the program slice under the training
loop's own spans: ``fit.step``, ``fit.zero_grad``, ``fit.optimizer`` and
``fit.history`` as the innermost span open (``gpbench.spans``)."""

from gpbench import spans


def read(rec):
    return spans.idle_ms_per_unit(rec, "loop", "fit.step")
