"""Training across processes, one per GPU: the data x model grid and its
reductions (``parallel/mesh.py``), tensor parallelism over the model group
(``parallel/tensor.py``) and FSDP over the data group
(``parallel/fsdp.py``)."""
