"""Data-parallel training over `torch.distributed` (twin of
`open_genie_tpu.parallel`): the mesh (`mesh.py`) and the collectives that
make a rank's loss the global batch's (`collectives.py`)."""
