"""Port adapters, one per model family: they make a configuration's data
from the seed and drive ``abstractgps_tpu_torch`` through its public
entry points. Nothing here computes a result the benchmark judges."""
