"""Analysis tail: cloud filtering, segmentation, dendrometry, normals (the
reference's PCL stages, src/Sfm.cpp:1323-1397, src/Segmentation.cpp,
src/DendrometryE.cpp)."""
