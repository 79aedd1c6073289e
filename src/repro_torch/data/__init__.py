from repro_torch.data.pipeline import DataPipeline, PipelineState

__all__ = ["DataPipeline", "PipelineState"]
