"""Device idle ms a training step in the program slice under the model:
``fit.loss``, ``fit.backward``, ``model.*`` or ``posterior.*`` as the
innermost span open, so outside every ``ops.*`` span (``gpbench.spans``)."""

from gpbench import spans


def read(rec):
    return spans.idle_ms_per_unit(rec, "model", "fit.step")
