"""Parallelism (counterpart of ``tapclip_tpu/parallel``): the train and eval
steps, the ``(data, model)`` and ``(data, pipe, model)`` meshes over
``torch.distributed`` process groups (``mesh.py``), the sharding rules and
placement, FSDP included (``sharding.py``), the collectives with gradients
(``collectives.py``) and the GPipe schedule of the ``pipe`` axis
(``pipeline.py``)."""
