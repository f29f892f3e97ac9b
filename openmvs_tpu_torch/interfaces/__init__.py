"""SfM front-end importers and exporters (apps/Interface* equivalents):
copies of the modules of ``openmvs_tpu/interfaces/`` (COLMAP, OpenMVG,
VisualSFM NVM and Bundler, Metashape and BlocksExchange, Polycam, MVSNet),
with the image undistortion of a distorted camera (``undistort.py``)
rebuilt without OpenCV.
"""
