"""WFST graph plane of the port: the graph containers, the lang bundle and
the ctypes binding of the native graph library (cpp/wfst.cc), which builds
training graphs and decoding graphs straight to CSR arrays."""
