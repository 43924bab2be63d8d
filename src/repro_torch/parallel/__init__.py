"""Expert parallelism of the port on ``torch.distributed``
(``repro/parallel``): the ambient mesh and its process groups
(``sharding``), the collectives of the EP schedules (``collectives``) and
which parameter leaves are expert leaves (``params``)."""
