"""Parallelism (counterpart of ``tapclip_tpu/parallel``): the train and eval
steps, the ``(data, model)`` mesh over ``torch.distributed`` process groups
(``mesh.py``), the sharding rules and placement (``sharding.py``) and the
collectives with gradients (``collectives.py``).  The pipe axis
(``pipeline.py``) is not yet ported."""
