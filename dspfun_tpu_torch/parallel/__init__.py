"""The device mesh of the port (PyTorch port of ``dspfun_tpu/parallel``):
ranks over ``torch.distributed`` (``mesh.py``), the Ulysses-sharded 3-D
DCT and motion's block batches (``sharded.py``), the whole-image spec
chain (``spec_sharded.py``), motion's whole-clip volume chain
(``motion_sharded.py``) and runs over several host processes
(``multihost.py``)."""
