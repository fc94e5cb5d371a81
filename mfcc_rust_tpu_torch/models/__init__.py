from .pipelines import (  # noqa: F401
    LibrosaMelPipeline,
    LibrosaMFCCPipeline,
    LogMFEPipeline,
    MFCCPipeline,
    MFEPipeline,
    Pipeline,
)
