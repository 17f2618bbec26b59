"""Model zoo of the port: the dense attention architectures of the
reference's ``repro.models`` on PyTorch (the serving slice; see ROADMAP M10
for what is still to come)."""
from .model import Model, build_model  # noqa: F401
