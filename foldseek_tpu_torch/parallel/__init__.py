"""Distribution over `torch.distributed`: one process a device, each holding
one row range of the target DB (`mesh.py`), the sharded prefilter and the
query-sharded align stage with their merges (`distributed.py`), and the
script that runs one rank of a multi-rank run (`worker.py`)."""
