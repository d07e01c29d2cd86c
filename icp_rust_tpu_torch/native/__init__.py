"""Native C++ host runtime: the reference-faithful oracle (``oracle``)
and the scan loader (``loader``), this package's own copies of the JAX
package's ``native/src`` sources, built with g++ at first use
(``native/build.py``)."""
