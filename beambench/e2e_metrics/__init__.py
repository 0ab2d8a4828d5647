"""End-to-end metric readers: ``e2e_metrics/<name>.py`` holds
``read(run, outcome)``, the metric's value from the host clock's record of
the window, or None where the run has nothing to read."""
