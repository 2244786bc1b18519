"""The benchmark of the PyTorch / CUDA port (``fateavatar_tpu_torch``).

Run one cell on a machine with an NVIDIA card, from the repository root::

    python3 portbench/run.py --workload fateavatar.reenact --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric lives in a file of its own and is found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``workloads/<cell>.json``,
``metrics/<metric>.py`` and ``drivers/<kind>.py`` (the code that drives one
kind of cell). The yardstick (``counts/``, ``reference/``, ``check.py``,
``timing.py``, ``generator.py``, ``assets.py``) imports nothing of the port.
"""
