"""Launch: the serving driver (``serve``)."""
