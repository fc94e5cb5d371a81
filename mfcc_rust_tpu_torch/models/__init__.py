from .pipelines import LogMFEPipeline, MFCCPipeline, MFEPipeline, Pipeline  # noqa: F401
