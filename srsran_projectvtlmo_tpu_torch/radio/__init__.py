from .gateway import LoopbackGateway, FileIqSink, FileIqSource
