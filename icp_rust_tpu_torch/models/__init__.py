"""ICP drivers and sequence odometry."""
