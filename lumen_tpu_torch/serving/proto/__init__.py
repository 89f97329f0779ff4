"""Wire protocol: protobuf messages + gRPC stubs.

``ml_service_pb2`` is generated from ``ml_service.proto`` (protoc); the
``_pb2_grpc`` module is hand-maintained (see its docstring). Regenerate with:

    cd lumen_tpu/serving/proto && protoc -I. -I/usr/include \
        --python_out=. --pyi_out=. ml_service.proto
"""

from . import ml_service_pb2, ml_service_pb2_grpc

__all__ = ["ml_service_pb2", "ml_service_pb2_grpc"]
