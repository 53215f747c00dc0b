"""The port's examples, the counterparts of the repository's
``examples/*.py``: ``crane_2d``, ``simple_vehicle``, ``solver_crosscheck``
and ``scale_out``.  Each runs on the card unless given ``--cpu``:

    python -m tpl_tpu_torch.examples.crane_2d [--cpu]
"""
