"""Device idle ms a query in the program slice under the autograd rules and
sweep drivers: an ``ops.*`` span as the innermost span open
(``gpbench.spans``)."""

from gpbench import spans


def read(rec):
    return spans.idle_ms_per_unit(rec, "ops", "posterior.mean_and_var")
