from .connector import (ClipActions, ClipRewards, ConnectorPipeline,
                        ConnectorV2, FlattenObs, FrameStack, GrayScale,
                        LearnerConnector, LearnerConnectorPipeline,
                        NormalizeObs, ResizeImage, ScaleObs,
                        UnsquashActions, atari_preprocessor)

__all__ = ["ConnectorV2", "ConnectorPipeline", "FlattenObs", "NormalizeObs",
           "FrameStack", "GrayScale", "ResizeImage", "ScaleObs",
           "atari_preprocessor", "ClipActions", "UnsquashActions",
           "LearnerConnector", "LearnerConnectorPipeline", "ClipRewards"]
