"""Data- and tensor-parallel training over `torch.distributed` (twin of
`open_genie_tpu.parallel`): the mesh (`mesh.py`), the collectives that
make a rank's loss the global batch's and run the split layers
(`collectives.py`), and each rank's slices of the weights (`tensor.py`)."""
