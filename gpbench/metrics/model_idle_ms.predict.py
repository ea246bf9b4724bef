"""Device idle ms a query in the program slice under the model:
``posterior.mean_and_var`` or ``model.*`` as the innermost span open, so
outside every ``ops.*`` span (``gpbench.spans``)."""

from gpbench import spans


def read(rec):
    return spans.idle_ms_per_unit(rec, "model", "posterior.mean_and_var")
