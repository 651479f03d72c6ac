"""Protocol gateways over the filer: the S3 REST gateway (``s3``) and
its SigV4 verifier (``s3_auth``). The port of ``seaweedfs_tpu/gateway``;
its WebDAV gateway comes with the remaining front ends (ROADMAP Queue 1).
"""
