from .pipeline import DataPipeline, PipelineState, SyntheticCorpus

__all__ = ["DataPipeline", "PipelineState", "SyntheticCorpus"]
