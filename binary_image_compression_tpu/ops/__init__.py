from . import bitpack  # noqa: F401
from . import predict  # noqa: F401
from . import entropy  # noqa: F401
from . import bitstream  # noqa: F401
from . import search  # noqa: F401
from . import fused_search  # noqa: F401
