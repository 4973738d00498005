"""Frame-axis sharding of the stage-1 fit over `torch.distributed`
(`spmd.py`) and the launcher of its rank processes (`ranks.py`)."""
