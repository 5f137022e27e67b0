"""Launch: the serving driver (``serve``) and the training driver's
``--scenario`` branch (``train``)."""
