"""Traffic kinds: ``kinds/<kind>.py`` drives the port for every mix whose
``kind`` names it, through ``run(Run) -> Outcome``."""
