"""Orientation-EKF constants shared by the lanes filter and its kernel. The
standard-layout single-instance EKF (reference ``ops/ekf.py``) is not ported
yet — see ROADMAP.md, "KF baseline and single-instance paths"."""

GRAVITY = 9.81  # orien_ekf.cpp:11 — gravity_ = (0, 0, 9.81)
