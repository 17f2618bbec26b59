"""Launch layer of the port: the serving and training entry points
(``serve.py``, ``train.py``), device meshes (``mesh.py``), sharding specs
and their DTensor placements (``sharding.py``), the abstract dry-run on the
production mesh (``dryrun.py``, ``hillclimb.py``) and its per-device
accounting against the H100's roofline (``hlo_analysis.py``).  Importing it
opens no process group and sets no environment variable."""
from .mesh import make_local_mesh, make_production_mesh  # noqa: F401
