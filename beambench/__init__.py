"""The benchmark of ``dsabeamformer_tpu_torch`` on one NVIDIA H100.

``python3 -m beambench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: a configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<name>.json``),
driven by the mix's kind (``kinds/<kind>.py``), its products attached and
checked by ``products/<name>.py``.  End-to-end metrics are read by
``e2e_metrics/<name>.py``, per-layer metrics by
``layer_metrics/<base name>.py``; a new cell, mix, product or metric is a
new file and a new entry, never an edit.

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
