"""Program-slice drivers, one per traffic generator (``gpbench.spans``).

``<generator>.py`` defines ``prepare(rec, seed, device)``: it builds the
cell's problem from the seed as the generator does, warms it, and returns
``run(span)``, which makes one slice of the generator's traffic, each call
into the program inside a ``span(spans.CALL_SPAN)``."""
