"""The paper's dataframe system on PyTorch: the formal data model (§3.2),
the dataframe algebra (§3.3) and a Modin-style partitioned implementation
(§4) with rewriting, opportunistic evaluation, prefix computation and
materialization reuse (§5/§6), running on CUDA unless told otherwise.

Public surface:
  * ``api.DataFrame`` / ``read_csv`` / ``from_pydict`` / ``get_dummies`` —
    pandas-flavoured API
  * ``algebra`` — the operator algebra for direct plan construction
  * ``Session`` — evaluation modes (eager / lazy / opportunistic) + reuse
  * ``QueryService`` — tenant sessions over one executor, store and budget
  * ``approx`` — progressive aggregation (§6.1.3)
"""
from . import algebra  # noqa: F401
from .api import DataFrame, concat, from_pydict, get_dummies, read_csv  # noqa: F401
from .config import CancelToken, SessionConfig  # noqa: F401
from .dtypes import Domain  # noqa: F401
from .frame import Column, Frame  # noqa: F401
from .partition import PartitionedFrame  # noqa: F401
from .faults import (  # noqa: F401
    ExecutorClosedError, IngestError, SpillIntegrityError,
    StatementCancelled, StoreClosedError, TaskError)
from .service import QueryService  # noqa: F401
from .session import (  # noqa: F401
    EvalMode, Session, StatementHandle, get_session, set_session)
from .store import BlockHandle, BlockStore, get_store, reset_store  # noqa: F401
from .trace import Metrics, Tracer  # noqa: F401
