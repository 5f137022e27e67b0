"""Models of the port: the MLP classifier of the femnist and cifar cells
(``simple``), and the language-model substrate's ssm (mamba2) and hybrid
(zamba2) families through ``build_model(cfg)``."""

from repro_torch.models.model import Model, build_model, cross_entropy  # noqa: F401
