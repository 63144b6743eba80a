"""The benchmark of ``vqacl_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything a
cell needs is found by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``, read by the generator the mix names) and its
entry (``entries/<kind>.py``); each metric of ``BENCHMARK.json`` is read
by ``metrics/<metric>.py``. ``reference/`` is the plain float32 model
that decides ``correct``; it imports nothing of the port.
"""
