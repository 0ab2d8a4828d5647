"""Per-layer metric readers: ``layer_metrics/<base name>.py`` holds
``read(run, outcome)``, the metric of every ``<base name>.<suffix>`` entry,
from the traced window (``outcome.trace``) and the cell's work; None where
the trace has nothing for it.  A trace with no CUDA kernel event has
already raised (``trace.TraceView``)."""
