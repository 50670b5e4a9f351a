from .logger import EpisodeLogger, ProfileTimer

__all__ = ["EpisodeLogger", "ProfileTimer"]
