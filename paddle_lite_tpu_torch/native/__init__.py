"""Native C++ pieces, built with g++ at first use (``native/build.py``)."""
