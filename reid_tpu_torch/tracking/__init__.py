"""Multi-object tracking on the device: Kalman filter, costs, assignment,
the slot-SoA tracker, its five method presets and the serve pipeline."""

from .methods import method_config
from .mot import load_mot_detections, write_mot_txt
from .tracker import Tracker, TrackerState, init_tracker_state

__all__ = ["method_config", "load_mot_detections", "write_mot_txt",
           "Tracker", "TrackerState", "init_tracker_state"]
