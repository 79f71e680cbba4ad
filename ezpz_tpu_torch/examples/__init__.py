"""Runnable demos of the port, the counterparts of ``examples/``:
``python -m ezpz_tpu_torch.examples.<basic|parser|scale> [--cpu]``. Each
solves on the card unless given ``--cpu``."""
