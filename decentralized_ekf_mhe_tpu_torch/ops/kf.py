"""KF baseline constants. Only the IMU→body lever arm is ported; the Kalman
filter itself (reference ``ops/kf.py``) waits — see ROADMAP.md, "KF baseline
and single-instance paths"."""

# body-frame IMU offset used for the published body velocity
# (DecentralEst.cpp:183-185)
DEFAULT_LEVER_ARM = (0.016041, 0.089061, 0.0579875)
