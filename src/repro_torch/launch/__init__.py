"""Launch: the serving driver (``serve``), the training driver (``train``),
and the dry-run in H100 form (``mesh``, ``specs``, ``sharding``,
``roofline``, ``dryrun``)."""
