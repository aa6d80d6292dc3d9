"""The numpy oracle (``numpy_ref``) and the differential cases that hold the
port's integrator against it (``cases``)."""
