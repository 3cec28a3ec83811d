"""Native (C++) host components, built with g++ at first use and loaded
via ctypes: the particle initializer's performance tier (the reference's
SSE / parallel_for lineage, `Compute.cpp:580-812`)."""
