"""Models of the port's slices: the MLP classifier of the femnist and cifar
cells (``simple``)."""
