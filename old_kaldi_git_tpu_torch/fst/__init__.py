"""WFST graph plane of the port: the graph containers and their file formats
(OKTFST01, OpenFst / CompactLattice), the lang bundle, the ctypes binding of
the native graph library (cpp/wfst.cc), which builds training graphs and
decoding graphs straight to CSR arrays, and the host algorithms of the fst*
command-line tools."""
