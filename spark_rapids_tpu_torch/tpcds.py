"""The 99 TPC-DS queries of ``benchmarks/tpcds.py``, written against the
port: one text a query, which ``chip_smoke.py`` runs on the card and the
parity tests run on the CPU.

Each query is a function of the session and the table dict
(``datagen.tpcds_tables``: the 22 tables of the simplified TPC-DS model).
The texts are the benchmark's, operation for operation, with ``F`` and
``Window`` from the port, so both packages plan the same tree; correlated
subqueries are decorrelated there as Spark's optimizer lowers them
(grouped aggregates joined back, semi and anti joins, cross joins with
one-row aggregates, windowed ratios, rollups). ``q75_brand_years`` is
q75 before its filter (the checks read it where q75's answer is empty).

Usage: python -m spark_rapids_tpu_torch.tpcds [--rows N]
[--queries q3,q7,...] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time


def make_session(device=None):
    """The benchmark's session: the ``ICI`` shuffle, four shuffle
    partitions, on ``device`` (the card unless the caller asks for the
    CPU)."""
    from .session import TorchSession
    return TorchSession({"spark.rapids.shuffle.mode": "ICI",
                         "spark.sql.shuffle.partitions": "4"}, device=device)


def load_tables(s, rows: int, parts: int = 4):
    """All 22 tables at store_sales-row scale ``rows`` (the other tables
    at ``load_tables``' ratios: ``datagen.tpcds_specs``)."""
    from .datagen import tpcds_tables
    return tpcds_tables(s, rows, parts)


def _F():
    from . import functions as F
    return F


def q3(s, t):
    """Brand sales in a month (TPC-DS 3)."""
    F = _F()
    ss, dt, item = t["store_sales"], t["date_dim"], t["item"]
    sel_i = item.filter(F.col("i_manufact_id").between(100, 250))
    nov = dt.filter(F.col("d_moy") == 11)
    return (ss.join(nov, on=ss["ss_sold_date_sk"] == nov["d_date_sk"])
            .join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
            .groupBy("d_year", "i_brand_id", "i_brand")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("sum_agg"))
            .sort("d_year", F.col("sum_agg").desc(), "i_brand_id")
            .limit(100))


def q7(s, t):
    """Demographic averages (TPC-DS 7)."""
    F = _F()
    ss, cd, dt, item, promo = (t["store_sales"], t["customer_demographics"],
                               t["date_dim"], t["item"], t["promotion"])
    sel_cd = cd.filter((F.col("cd_gender") == "M")
                       & (F.col("cd_marital_status") == "S")
                       & (F.col("cd_education_status") == "College"))
    y = dt.filter(F.col("d_year") == 2000)
    sel_p = promo.filter((F.col("p_channel_email") == "N")
                         | (F.col("p_channel_event") == "N"))
    return (ss.join(sel_cd, on=ss["ss_cdemo_sk"] == sel_cd["cd_demo_sk"])
            .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
            .join(sel_p, on=ss["ss_promo_sk"] == sel_p["p_promo_sk"])
            .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
            .groupBy("i_item_id")
            .agg(F.avg(F.col("ss_quantity")).alias("agg1"),
                 F.avg(F.col("ss_list_price")).alias("agg2"),
                 F.avg(F.col("ss_coupon_amt")).alias("agg3"),
                 F.avg(F.col("ss_sales_price")).alias("agg4"))
            .sort("i_item_id")
            .limit(100))


def q12(s, t):
    """Web revenue ratio by class over a window (TPC-DS 12)."""
    F = _F()
    from .window import Window
    ws, item, dt = t["web_sales"], t["item"], t["date_dim"]
    sel_i = item.filter(F.col("i_category").isin(
        "Sports", "Books", "Home"))
    days = dt.filter((F.col("d_date") >= F.lit(10371))
                     & (F.col("d_date") <= F.lit(10401)))
    j = (ws.join(sel_i, on=ws["ws_item_sk"] == sel_i["i_item_sk"])
         .join(days, on=ws["ws_sold_date_sk"] == days["d_date_sk"])
         .groupBy("i_item_id", "i_category", "i_class", "i_current_price")
         .agg(F.sum(F.col("ws_ext_sales_price")).alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (j.withColumn(
                "revenueratio",
                F.col("itemrevenue") * 100.0
                / F.sum(F.col("itemrevenue")).over(w))
            .select("i_item_id", "i_category", "i_class", "itemrevenue",
                    "revenueratio")
            .sort("i_category", "i_class", "i_item_id")
            .limit(100))


def q13(s, t):
    """Conditional averages over demographic brackets (TPC-DS 13)."""
    F = _F()
    ss, cd, hd, ca, dt, store = (t["store_sales"],
                                 t["customer_demographics"],
                                 t["household_demographics"],
                                 t["customer_address"], t["date_dim"],
                                 t["store"])
    y = dt.filter(F.col("d_year") == 2001)
    sel_cd = cd.filter(F.col("cd_marital_status").isin("M", "S", "W"))
    sel_hd = hd.filter(F.col("hd_dep_count").isin(1, 3))
    sel_ca = ca.filter(F.col("ca_state").isin("TX", "OH", "CA", "NY", "GA",
                                              "TN"))
    return (ss.join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
            .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
            .join(sel_cd, on=ss["ss_cdemo_sk"] == sel_cd["cd_demo_sk"])
            .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
            .join(sel_ca, on=ss["ss_addr_sk"] == sel_ca["ca_address_sk"])
            .agg(F.avg(F.col("ss_quantity")).alias("avg_qty"),
                 F.avg(F.col("ss_ext_sales_price")).alias("avg_esp"),
                 F.avg(F.col("ss_ext_wholesale_cost")).alias("avg_ewc"),
                 F.sum(F.col("ss_ext_wholesale_cost")).alias("sum_ewc")))


def q15(s, t):
    """Catalog sales by zip cohort (TPC-DS 15)."""
    F = _F()
    cs, cust, ca, dt = (t["catalog_sales"], t["customer"],
                        t["customer_address"], t["date_dim"])
    q = dt.filter((F.col("d_qoy") == 1) & (F.col("d_year") == 2001))
    zips = [f"{z:05d}" for z in range(10000, 10010)]
    return (cs.join(cust, on=cs["cs_bill_customer_sk"]
                    == cust["c_customer_sk"])
            .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"])
            .join(q, on=cs["cs_sold_date_sk"] == q["d_date_sk"])
            .filter(F.col("ca_zip").isin(*zips)
                    | F.col("ca_state").isin("CA", "WA", "GA")
                    | (F.col("cs_sales_price") > 250.0))
            .groupBy("ca_zip")
            .agg(F.sum(F.col("cs_sales_price")).alias("total"))
            .sort("ca_zip")
            .limit(100))


def q19(s, t):
    """Brand revenue, manager cohort (TPC-DS 19)."""
    F = _F()
    ss, dt, item, cust, ca, store = (t["store_sales"], t["date_dim"],
                                     t["item"], t["customer"],
                                     t["customer_address"], t["store"])
    sel_i = item.filter(F.col("i_manager_id").between(1, 20))
    m = dt.filter((F.col("d_moy") == 11) & (F.col("d_year") == 1998))
    return (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
            .join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
            .join(cust, on=ss["ss_customer_sk"] == cust["c_customer_sk"])
            .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"])
            .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
            .filter(F.col("ca_city") != F.col("s_city"))
            .groupBy("i_brand_id", "i_brand", "i_manufact_id")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("ext_price"))
            .sort(F.col("ext_price").desc(), "i_brand_id")
            .limit(100))


def q20(s, t):
    """Catalog revenue ratio by class over a window (TPC-DS 20)."""
    F = _F()
    from .window import Window
    cs, item, dt = t["catalog_sales"], t["item"], t["date_dim"]
    sel_i = item.filter(F.col("i_category").isin(
        "Sports", "Books", "Home"))
    days = dt.filter((F.col("d_date") >= F.lit(10371))
                     & (F.col("d_date") <= F.lit(10401)))
    j = (cs.join(sel_i, on=cs["cs_item_sk"] == sel_i["i_item_sk"])
         .join(days, on=cs["cs_sold_date_sk"] == days["d_date_sk"])
         .groupBy("i_item_id", "i_category", "i_class", "i_current_price")
         .agg(F.sum(F.col("cs_ext_sales_price")).alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (j.withColumn(
                "revenueratio",
                F.col("itemrevenue") * 100.0
                / F.sum(F.col("itemrevenue")).over(w))
            .select("i_item_id", "i_category", "i_class", "itemrevenue",
                    "revenueratio")
            .sort("i_category", "i_class", "i_item_id")
            .limit(100))


def q25(s, t):
    """Store sales/returns/catalog profit triple join (TPC-DS 25)."""
    F = _F()
    ss, sr, cs, dt, store, item = (t["store_sales"], t["store_returns"],
                                   t["catalog_sales"], t["date_dim"],
                                   t["store"], t["item"])
    d1 = dt.filter(F.col("d_year") == 2000) \
        .select(F.col("d_date_sk").alias("d1_sk"))
    d2 = dt.filter(F.col("d_year").between(2000, 2002)) \
        .select(F.col("d_date_sk").alias("d2_sk"))
    d3 = dt.filter(F.col("d_year").between(2000, 2002)) \
        .select(F.col("d_date_sk").alias("d3_sk"))
    j = (ss.join(sr, on=(ss["ss_customer_sk"] == sr["sr_customer_sk"])
                 & (ss["ss_item_sk"] == sr["sr_item_sk"])
                 & (ss["ss_ticket_number"] == sr["sr_ticket_number"]))
         .join(cs, on=(sr["sr_customer_sk"] == cs["cs_bill_customer_sk"])
               & (sr["sr_item_sk"] == cs["cs_item_sk"]))
         .join(d1, on=ss["ss_sold_date_sk"] == d1["d1_sk"])
         .join(d2, on=sr["sr_returned_date_sk"] == d2["d2_sk"])
         .join(d3, on=cs["cs_sold_date_sk"] == d3["d3_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"]))
    return (j.groupBy("i_item_id", "s_store_id", "s_store_name")
            .agg(F.sum(F.col("ss_net_profit")).alias("store_sales_profit"),
                 F.sum(F.col("sr_net_loss")).alias("store_returns_loss"),
                 F.sum(F.col("cs_net_profit")).alias("catalog_sales_profit"))
            .sort("i_item_id", "s_store_id")
            .limit(100))


def q26(s, t):
    """Catalog demographic averages (TPC-DS 26)."""
    F = _F()
    cs, cd, dt, item, promo = (t["catalog_sales"],
                               t["customer_demographics"], t["date_dim"],
                               t["item"], t["promotion"])
    sel_cd = cd.filter((F.col("cd_gender") == "M")
                       & (F.col("cd_marital_status") == "S")
                       & (F.col("cd_education_status") == "College"))
    y = dt.filter(F.col("d_year") == 2000)
    sel_p = promo.filter((F.col("p_channel_email") == "N")
                         | (F.col("p_channel_event") == "N"))
    return (cs.join(sel_cd, on=cs["cs_bill_cdemo_sk"] == sel_cd["cd_demo_sk"])
            .join(y, on=cs["cs_sold_date_sk"] == y["d_date_sk"])
            .join(sel_p, on=cs["cs_promo_sk"] == sel_p["p_promo_sk"])
            .join(item, on=cs["cs_item_sk"] == item["i_item_sk"])
            .groupBy("i_item_id")
            .agg(F.avg(F.col("cs_quantity")).alias("agg1"),
                 F.avg(F.col("cs_list_price")).alias("agg2"),
                 F.avg(F.col("cs_coupon_amt")).alias("agg3"),
                 F.avg(F.col("cs_sales_price")).alias("agg4"))
            .sort("i_item_id")
            .limit(100))


def q27(s, t):
    """State rollup of store demographics (TPC-DS 27: GROUP BY ROLLUP)."""
    F = _F()
    ss, cd, dt, store, item = (t["store_sales"],
                               t["customer_demographics"], t["date_dim"],
                               t["store"], t["item"])
    sel_cd = cd.filter((F.col("cd_gender") == "F")
                       & (F.col("cd_marital_status") == "M")
                       & (F.col("cd_education_status") == "College"))
    y = dt.filter(F.col("d_year") == 2002)
    sel_s = store.filter(F.col("s_state").isin("TN", "CA", "TX"))
    return (ss.join(sel_cd, on=ss["ss_cdemo_sk"] == sel_cd["cd_demo_sk"])
            .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
            .join(sel_s, on=ss["ss_store_sk"] == sel_s["s_store_sk"])
            .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
            .rollup("i_item_id", "s_state")
            .agg(F.avg(F.col("ss_quantity")).alias("agg1"),
                 F.avg(F.col("ss_list_price")).alias("agg2"),
                 F.avg(F.col("ss_coupon_amt")).alias("agg3"),
                 F.avg(F.col("ss_sales_price")).alias("agg4"))
            .sort("i_item_id", "s_state")
            .limit(100))


def q29(s, t):
    """Quantity sold/returned/re-sold (TPC-DS 29)."""
    F = _F()
    ss, sr, cs, dt, store, item = (t["store_sales"], t["store_returns"],
                                   t["catalog_sales"], t["date_dim"],
                                   t["store"], t["item"])
    d1 = dt.filter(F.col("d_year") == 1999) \
        .select(F.col("d_date_sk").alias("d1_sk"))
    d2 = dt.filter(F.col("d_year").between(1999, 2001)) \
        .select(F.col("d_date_sk").alias("d2_sk"))
    d3 = dt.filter(F.col("d_year").between(1999, 2001)) \
        .select(F.col("d_date_sk").alias("d3_sk"))
    j = (ss.join(sr, on=(ss["ss_customer_sk"] == sr["sr_customer_sk"])
                 & (ss["ss_item_sk"] == sr["sr_item_sk"])
                 & (ss["ss_ticket_number"] == sr["sr_ticket_number"]))
         .join(cs, on=(sr["sr_customer_sk"] == cs["cs_bill_customer_sk"])
               & (sr["sr_item_sk"] == cs["cs_item_sk"]))
         .join(d1, on=ss["ss_sold_date_sk"] == d1["d1_sk"])
         .join(d2, on=sr["sr_returned_date_sk"] == d2["d2_sk"])
         .join(d3, on=cs["cs_sold_date_sk"] == d3["d3_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"]))
    return (j.groupBy("i_item_id", "s_store_id", "s_store_name")
            .agg(F.sum(F.col("ss_quantity")).alias("store_sales_quantity"),
                 F.sum(F.col("sr_return_quantity"))
                 .alias("store_returns_quantity"),
                 F.sum(F.col("cs_quantity")).alias("catalog_sales_quantity"))
            .sort("i_item_id", "s_store_id")
            .limit(100))


def q32(s, t):
    """Excess discount: 1.3 × per-item average (TPC-DS 32 decorrelated)."""
    F = _F()
    cs, item, dt = t["catalog_sales"], t["item"], t["date_dim"]
    sel_i = item.filter(F.col("i_manufact_id") == 977)
    days = dt.filter((F.col("d_date") >= F.lit(10900))
                     & (F.col("d_date") <= F.lit(10990)))
    base = (cs.join(days, on=cs["cs_sold_date_sk"] == days["d_date_sk"])
            .join(sel_i, on=cs["cs_item_sk"] == sel_i["i_item_sk"]))
    thresh = (base.groupBy("i_item_sk")
              .agg((F.avg(F.col("cs_ext_discount_amt")) * 1.3)
                   .alias("disc_thresh"))
              .select(F.col("i_item_sk").alias("th_item"),
                      F.col("disc_thresh")))
    return (base.join(thresh, on=base["i_item_sk"] == thresh["th_item"])
            .filter(F.col("cs_ext_discount_amt") > F.col("disc_thresh"))
            .agg(F.sum(F.col("cs_ext_discount_amt"))
                 .alias("excess_discount_amount")))


def q36(s, t):
    """Gross-margin rollup with rank inside hierarchy level (TPC-DS 36)."""
    F = _F()
    from .window import Window
    ss, dt, item, store = (t["store_sales"], t["date_dim"], t["item"],
                           t["store"])
    y = dt.filter(F.col("d_year") == 2001)
    sel_s = store.filter(F.col("s_state").isin("TN", "CA"))
    g = (ss.join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
         .join(sel_s, on=ss["ss_store_sk"] == sel_s["s_store_sk"])
         .rollup("i_category", "i_class")
         .agg((F.sum(F.col("ss_net_profit"))
               / F.sum(F.col("ss_ext_sales_price"))).alias("gross_margin"),
              F.grouping("i_category").alias("g_cat"),
              F.grouping("i_class").alias("g_class")))
    g = g.withColumn("lochierarchy", F.col("g_cat") + F.col("g_class"))
    w = Window.partitionBy("lochierarchy").orderBy(
        F.col("gross_margin").asc())
    return (g.withColumn("rank_within_parent", F.rank().over(w))
            .select("gross_margin", "i_category", "i_class", "lochierarchy",
                    "rank_within_parent")
            .sort(F.col("lochierarchy").desc(), "i_category",
                  "rank_within_parent")
            .limit(100))


def q37(s, t):
    """Items with inventory in a window joined to catalog sales (TPC-DS 37)."""
    F = _F()
    item, inv, dt, cs = (t["item"], t["inventory"], t["date_dim"],
                         t["catalog_sales"])
    sel_i = item.filter((F.col("i_current_price") >= 20.0)
                        & (F.col("i_current_price") <= 150.0)
                        & F.col("i_manufact_id").between(500, 800))
    days = dt.filter((F.col("d_date") >= F.lit(10300))
                     & (F.col("d_date") <= F.lit(10660)))
    stocked = (inv.filter(F.col("inv_quantity_on_hand").between(100, 500))
               .join(days, on=inv["inv_date_sk"] == days["d_date_sk"])
               .join(sel_i, on=inv["inv_item_sk"] == sel_i["i_item_sk"],
                     how="leftsemi")
               .select(F.col("inv_item_sk").alias("st_item")).distinct())
    return (sel_i.join(stocked, on=sel_i["i_item_sk"] == stocked["st_item"],
                       how="leftsemi")
            .join(cs, on=sel_i["i_item_sk"] == cs["cs_item_sk"],
                  how="leftsemi")
            .select("i_item_id", "i_item_sk", "i_current_price")
            .sort("i_item_id")
            .limit(100))


def q42(s, t):
    """Category revenue in a month (TPC-DS 42)."""
    F = _F()
    ss, dt, item = t["store_sales"], t["date_dim"], t["item"]
    m = dt.filter((F.col("d_moy") == 11) & (F.col("d_year") == 2000))
    return (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
            .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
            .groupBy("d_year", "i_category")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("total"))
            .sort(F.col("total").desc(), "d_year", "i_category")
            .limit(100))


def q43(s, t):
    """Store sales pivoted by day of week (TPC-DS 43)."""
    F = _F()
    ss, dt, store = t["store_sales"], t["date_dim"], t["store"]
    y = dt.filter(F.col("d_year") == 2000)
    j = (ss.join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"]))
    aggs = []
    for i, day in enumerate(["Sunday", "Monday", "Tuesday", "Wednesday",
                             "Thursday", "Friday", "Saturday"]):
        aggs.append(F.sum(F.when(F.col("d_day_name") == day,
                                 F.col("ss_sales_price"))
                          .otherwise(F.lit(None)))
                    .alias(f"{day[:3].lower()}_sales"))
    return (j.groupBy("s_store_name", "s_store_id")
            .agg(*aggs)
            .sort("s_store_name", "s_store_id")
            .limit(100))


def q48(s, t):
    """Bracketed quantity sum over demographics/address (TPC-DS 48)."""
    F = _F()
    ss, cd, ca, dt, store = (t["store_sales"], t["customer_demographics"],
                             t["customer_address"], t["date_dim"],
                             t["store"])
    y = dt.filter(F.col("d_year") == 2000)
    j = (ss.join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
         .join(cd, on=ss["ss_cdemo_sk"] == cd["cd_demo_sk"])
         .join(ca, on=ss["ss_addr_sk"] == ca["ca_address_sk"]))
    b1 = ((F.col("cd_marital_status") == "M")
          & (F.col("cd_education_status") == "4 yr Degree")
          & F.col("ss_sales_price").between(100.0, 150.0))
    b2 = ((F.col("cd_marital_status") == "D")
          & (F.col("cd_education_status") == "2 yr Degree")
          & F.col("ss_sales_price").between(50.0, 100.0))
    b3 = ((F.col("cd_marital_status") == "S")
          & (F.col("cd_education_status") == "College")
          & F.col("ss_sales_price").between(150.0, 200.0))
    return (j.filter(b1 | b2 | b3)
            .agg(F.sum(F.col("ss_quantity")).alias("total_quantity")))


def q50(s, t):
    """Return latency day-buckets per store (TPC-DS 50)."""
    F = _F()
    ss, sr, dt, store = (t["store_sales"], t["store_returns"],
                         t["date_dim"], t["store"])
    d2 = dt.filter((F.col("d_year") == 2001) & (F.col("d_moy") == 8)) \
        .select(F.col("d_date_sk").alias("ret_sk"))
    j = (ss.join(sr, on=(ss["ss_ticket_number"] == sr["sr_ticket_number"])
                 & (ss["ss_item_sk"] == sr["sr_item_sk"])
                 & (ss["ss_customer_sk"] == sr["sr_customer_sk"]))
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(d2, on=sr["sr_returned_date_sk"] == d2["ret_sk"]))
    lag = F.col("sr_returned_date_sk") - F.col("ss_sold_date_sk")
    return (j.groupBy("s_store_name", "s_store_id")
            .agg(F.sum(F.when(lag <= 30, 1).otherwise(0)).alias("d30"),
                 F.sum(F.when((lag > 30) & (lag <= 60), 1).otherwise(0))
                 .alias("d31_60"),
                 F.sum(F.when((lag > 60) & (lag <= 90), 1).otherwise(0))
                 .alias("d61_90"),
                 F.sum(F.when((lag > 90) & (lag <= 120), 1).otherwise(0))
                 .alias("d91_120"),
                 F.sum(F.when(lag > 120, 1).otherwise(0)).alias("d_gt120"))
            .sort("s_store_name", "s_store_id")
            .limit(100))


def q52(s, t):
    """Brand extended price in a month (TPC-DS 52)."""
    F = _F()
    ss, dt, item = t["store_sales"], t["date_dim"], t["item"]
    m = dt.filter((F.col("d_moy") == 11) & (F.col("d_year") == 2000))
    return (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
            .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
            .groupBy("d_year", "i_brand_id", "i_brand")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("ext_price"))
            .sort("d_year", F.col("ext_price").desc(), "i_brand_id")
            .limit(100))


def q53(s, t):
    """Manufacturer quarterly sales vs average (TPC-DS 53)."""
    F = _F()
    from .window import Window
    ss, dt, item, store = (t["store_sales"], t["date_dim"], t["item"],
                           t["store"])
    months = dt.filter(F.col("d_month_seq").between(350, 361))
    sel_i = item.filter(F.col("i_class").isin(
        "class01", "class03", "class05", "class07"))
    g = (ss.join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
         .join(months, on=ss["ss_sold_date_sk"] == months["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .groupBy("i_manufact_id", "d_qoy")
         .agg(F.sum(F.col("ss_sales_price")).alias("sum_sales")))
    w = Window.partitionBy("i_manufact_id")
    g = g.withColumn("avg_quarterly_sales",
                     F.avg(F.col("sum_sales")).over(w))
    return (g.filter(
                F.when(F.col("avg_quarterly_sales") > 0.0,
                       F.abs(F.col("sum_sales")
                             - F.col("avg_quarterly_sales"))
                       / F.col("avg_quarterly_sales"))
                .otherwise(F.lit(None)) > 0.1)
            .select("i_manufact_id", "sum_sales", "avg_quarterly_sales")
            .sort("avg_quarterly_sales", F.col("sum_sales").desc(),
                  "i_manufact_id")
            .limit(100))


def q55(s, t):
    """Brand revenue for one manager month (TPC-DS 55)."""
    F = _F()
    ss, dt, item = t["store_sales"], t["date_dim"], t["item"]
    m = dt.filter((F.col("d_moy") == 11) & (F.col("d_year") == 1999))
    sel_i = item.filter(F.col("i_manager_id").between(20, 40))
    return (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
            .join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
            .groupBy("i_brand_id", "i_brand")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("ext_price"))
            .sort(F.col("ext_price").desc(), "i_brand_id")
            .limit(100))


def q61(s, t):
    """Promotional to total revenue ratio (TPC-DS 61)."""
    F = _F()
    ss, promo, dt, store, cust, ca, item = (
        t["store_sales"], t["promotion"], t["date_dim"], t["store"],
        t["customer"], t["customer_address"], t["item"])
    m = dt.filter((F.col("d_year") == 1998) & (F.col("d_moy") == 11))
    sel_i = item.filter(F.col("i_category") == "Jewelry")
    sel_ca = ca.filter(F.col("ca_gmt_offset") <= -6.0)
    base = (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
            .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
            .join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
            .join(cust, on=ss["ss_customer_sk"] == cust["c_customer_sk"])
            .join(sel_ca, on=cust["c_current_addr_sk"]
                  == sel_ca["ca_address_sk"]))
    promos = (base.join(promo, on=base["ss_promo_sk"] == promo["p_promo_sk"])
              .filter((F.col("p_channel_dmail") == "Y")
                      | (F.col("p_channel_email") == "Y")
                      | (F.col("p_channel_tv") == "Y"))
              .agg(F.sum(F.col("ss_ext_sales_price")).alias("promotions")))
    total = base.agg(F.sum(F.col("ss_ext_sales_price")).alias("total"))
    return (promos.crossJoin(total)
            .withColumn("ratio",
                        F.col("promotions") * 100.0 / F.col("total")))


def q62(s, t):
    """Web ship-latency day buckets (TPC-DS 62)."""
    F = _F()
    ws, dt, sm, site = (t["web_sales"], t["date_dim"], t["ship_mode"],
                        t["web_site"])
    months = dt.filter(F.col("d_month_seq").between(350, 361)) \
        .select(F.col("d_date_sk").alias("ship_sk"))
    j = (ws.join(months, on=ws["ws_ship_date_sk"] == months["ship_sk"])
         .join(sm, on=ws["ws_ship_mode_sk"] == sm["sm_ship_mode_sk"])
         .join(site, on=ws["ws_web_site_sk"] == site["web_site_sk"]))
    lag = F.col("ws_ship_date_sk") - F.col("ws_sold_date_sk")
    return (j.groupBy("sm_type", "web_name")
            .agg(F.sum(F.when(lag <= 30, 1).otherwise(0)).alias("d30"),
                 F.sum(F.when((lag > 30) & (lag <= 60), 1).otherwise(0))
                 .alias("d31_60"),
                 F.sum(F.when((lag > 60) & (lag <= 90), 1).otherwise(0))
                 .alias("d61_90"),
                 F.sum(F.when((lag > 90) & (lag <= 120), 1).otherwise(0))
                 .alias("d91_120"),
                 F.sum(F.when(lag > 120, 1).otherwise(0)).alias("d_gt120"))
            .sort("sm_type", "web_name")
            .limit(100))


def q63(s, t):
    """Manager monthly sales vs average (TPC-DS 63)."""
    F = _F()
    from .window import Window
    ss, dt, item, store = (t["store_sales"], t["date_dim"], t["item"],
                           t["store"])
    months = dt.filter(F.col("d_month_seq").between(350, 361))
    sel_i = item.filter(F.col("i_category").isin("Books", "Children",
                                                 "Electronics"))
    g = (ss.join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
         .join(months, on=ss["ss_sold_date_sk"] == months["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .groupBy("i_manager_id", "d_moy")
         .agg(F.sum(F.col("ss_sales_price")).alias("sum_sales")))
    w = Window.partitionBy("i_manager_id")
    g = g.withColumn("avg_monthly_sales",
                     F.avg(F.col("sum_sales")).over(w))
    return (g.filter(
                F.when(F.col("avg_monthly_sales") > 0.0,
                       F.abs(F.col("sum_sales")
                             - F.col("avg_monthly_sales"))
                       / F.col("avg_monthly_sales"))
                .otherwise(F.lit(None)) > 0.1)
            .select("i_manager_id", "sum_sales", "avg_monthly_sales")
            .sort("i_manager_id", F.col("avg_monthly_sales").desc(),
                  "sum_sales")
            .limit(100))


def q65(s, t):
    """Stores selling items at <=10% of average revenue (TPC-DS 65)."""
    F = _F()
    ss, dt, store, item = (t["store_sales"], t["date_dim"], t["store"],
                           t["item"])
    months = dt.filter(F.col("d_month_seq").between(350, 361))
    rev = (ss.join(months, on=ss["ss_sold_date_sk"] == months["d_date_sk"])
           .groupBy("ss_store_sk", "ss_item_sk")
           .agg(F.sum(F.col("ss_sales_price")).alias("revenue")))
    avg_rev = (rev.groupBy("ss_store_sk")
               .agg(F.avg(F.col("revenue")).alias("ave"))
               .select(F.col("ss_store_sk").alias("a_store"), F.col("ave")))
    return (rev.join(avg_rev, on=rev["ss_store_sk"] == avg_rev["a_store"])
            .filter(F.col("revenue") <= 0.1 * F.col("ave"))
            .join(store, on=rev["ss_store_sk"] == store["s_store_sk"])
            .join(item, on=rev["ss_item_sk"] == item["i_item_sk"])
            .select("s_store_name", "i_item_id", "revenue")
            .sort("s_store_name", "i_item_id")
            .limit(100))


def q68(s, t):
    """City customer purchase profile (TPC-DS 68)."""
    F = _F()
    ss, dt, store, hd, ca, cust = (t["store_sales"], t["date_dim"],
                                   t["store"], t["household_demographics"],
                                   t["customer_address"], t["customer"])
    days = dt.filter((F.col("d_dom").between(1, 2))
                     & F.col("d_year").isin(1999, 2000, 2001))
    sel_hd = hd.filter((F.col("hd_dep_count") == 4)
                       | (F.col("hd_vehicle_count") == 3))
    sel_ca = ca.select(F.col("ca_address_sk").alias("pos_addr"),
                       F.col("ca_city").alias("bought_city"))
    g = (ss.join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .join(sel_ca, on=ss["ss_addr_sk"] == sel_ca["pos_addr"])
         .groupBy("ss_ticket_number", "ss_customer_sk", "bought_city")
         .agg(F.sum(F.col("ss_ext_sales_price")).alias("extended_price"),
              F.sum(F.col("ss_ext_list_price")).alias("list_price"),
              F.sum(F.col("ss_ext_tax")).alias("extended_tax")))
    j = (g.join(cust, on=g["ss_customer_sk"] == cust["c_customer_sk"])
         .join(t["customer_address"],
               on=cust["c_current_addr_sk"]
               == t["customer_address"]["ca_address_sk"])
         .filter(F.col("ca_city") != F.col("bought_city")))
    return (j.select("c_last_name", "c_first_name", "ca_city",
                     "bought_city", "ss_ticket_number", "extended_price",
                     "extended_tax", "list_price")
            .sort("c_last_name", "ss_ticket_number")
            .limit(100))


def q73(s, t):
    """Households buying 1-5 tickets (TPC-DS 73)."""
    F = _F()
    ss, dt, store, hd, cust = (t["store_sales"], t["date_dim"], t["store"],
                               t["household_demographics"], t["customer"])
    days = dt.filter(F.col("d_dom").between(1, 2)
                     & F.col("d_year").isin(1999, 2000, 2001))
    sel_hd = hd.filter(F.col("hd_buy_potential").isin(">10000", "Unknown")
                       & (F.col("hd_vehicle_count") > 0))
    g = (ss.join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .groupBy("ss_ticket_number", "ss_customer_sk")
         .agg(F.count_star().alias("cnt"))
         .filter(F.col("cnt").between(1, 5)))
    return (g.join(cust, on=g["ss_customer_sk"] == cust["c_customer_sk"])
            .select("c_last_name", "c_first_name", "ss_ticket_number",
                    "cnt")
            .sort(F.col("cnt").desc(), "c_last_name")
            .limit(100))


def q79(s, t):
    """Customer city amounts/profit (TPC-DS 79)."""
    F = _F()
    ss, dt, store, hd, cust = (t["store_sales"], t["date_dim"], t["store"],
                               t["household_demographics"], t["customer"])
    days = dt.filter((F.col("d_dow") == 1)
                     & F.col("d_year").isin(1999, 2000, 2001))
    sel_s = store.filter(F.col("s_number_employees").between(200, 295))
    sel_hd = hd.filter((F.col("hd_dep_count") == 6)
                       | (F.col("hd_vehicle_count") > 2))
    g = (ss.join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .join(sel_s, on=ss["ss_store_sk"] == sel_s["s_store_sk"])
         .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .groupBy("ss_ticket_number", "ss_customer_sk", "s_city")
         .agg(F.sum(F.col("ss_coupon_amt")).alias("amt"),
              F.sum(F.col("ss_net_profit")).alias("profit")))
    return (g.join(cust, on=g["ss_customer_sk"] == cust["c_customer_sk"])
            .select("c_last_name", "c_first_name", "s_city", "amt",
                    "profit", "ss_ticket_number")
            .sort("c_last_name", "c_first_name", "ss_ticket_number")
            .limit(100))


def q82(s, t):
    """Store items with bounded inventory (TPC-DS 82)."""
    F = _F()
    item, inv, dt, ss = (t["item"], t["inventory"], t["date_dim"],
                         t["store_sales"])
    sel_i = item.filter((F.col("i_current_price").between(30.0, 150.0))
                        & F.col("i_manufact_id").between(300, 600))
    days = dt.filter((F.col("d_date") >= F.lit(10300))
                     & (F.col("d_date") <= F.lit(10660)))
    stocked = (inv.filter(F.col("inv_quantity_on_hand").between(100, 500))
               .join(days, on=inv["inv_date_sk"] == days["d_date_sk"])
               .select(F.col("inv_item_sk").alias("st_item")).distinct())
    return (sel_i.join(stocked, on=sel_i["i_item_sk"] == stocked["st_item"],
                       how="leftsemi")
            .join(ss, on=sel_i["i_item_sk"] == ss["ss_item_sk"],
                  how="leftsemi")
            .select("i_item_id", "i_item_sk", "i_current_price")
            .sort("i_item_id")
            .limit(100))


def q89(s, t):
    """Class monthly sales vs average (TPC-DS 89)."""
    F = _F()
    from .window import Window
    ss, dt, item, store = (t["store_sales"], t["date_dim"], t["item"],
                           t["store"])
    y = dt.filter(F.col("d_year") == 1999)
    a = item.filter(F.col("i_category").isin("Books", "Electronics",
                                             "Sports")
                    & F.col("i_class").isin("class01", "class05",
                                            "class09"))
    b = item.filter(F.col("i_category").isin("Men", "Jewelry", "Women")
                    & F.col("i_class").isin("class02", "class06",
                                            "class10"))
    sel_i = a.union(b)
    g = (ss.join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
         .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .groupBy("i_category", "i_class", "i_brand", "s_store_name",
                  "s_store_id", "d_moy")
         .agg(F.sum(F.col("ss_sales_price")).alias("sum_sales")))
    w = Window.partitionBy("i_category", "i_brand", "s_store_name",
                           "s_store_id")
    g = g.withColumn("avg_monthly_sales",
                     F.avg(F.col("sum_sales")).over(w))
    return (g.filter(
                F.when(F.col("avg_monthly_sales") != 0.0,
                       F.abs(F.col("sum_sales")
                             - F.col("avg_monthly_sales"))
                       / F.col("avg_monthly_sales"))
                .otherwise(F.lit(None)) > 0.1)
            .select("i_category", "i_class", "i_brand", "s_store_name",
                    "d_moy", "sum_sales", "avg_monthly_sales")
            .sort(F.col("sum_sales") - F.col("avg_monthly_sales"),
                  "s_store_name")
            .limit(100))


def q90(s, t):
    """AM to PM web sales ratio (TPC-DS 90, bucketed in one pass)."""
    F = _F()
    ws, td = t["web_sales"], t["time_dim"]
    j = ws.join(td, on=ws["ws_sold_time_sk"] == td["t_time_sk"])
    am_c = F.sum(F.when(F.col("t_hour").between(8, 9), 1).otherwise(0))
    pm_c = F.sum(F.when(F.col("t_hour").between(19, 20), 1).otherwise(0))
    return j.agg(am_c.alias("amc"), pm_c.alias("pmc")).withColumn(
        "am_pm_ratio",
        F.when(F.col("pmc") > 0,
               F.col("amc").cast("double") / F.col("pmc").cast("double"))
        .otherwise(F.lit(None)))


def q92(s, t):
    """Web excess discount (TPC-DS 92 decorrelated)."""
    F = _F()
    ws, item, dt = t["web_sales"], t["item"], t["date_dim"]
    sel_i = item.filter(F.col("i_manufact_id") == 350)
    days = dt.filter((F.col("d_date") >= F.lit(10900))
                     & (F.col("d_date") <= F.lit(10990)))
    base = (ws.join(days, on=ws["ws_sold_date_sk"] == days["d_date_sk"])
            .join(sel_i, on=ws["ws_item_sk"] == sel_i["i_item_sk"]))
    thresh = (base.groupBy("i_item_sk")
              .agg((F.avg(F.col("ws_ext_discount_amt")) * 1.3)
                   .alias("disc_thresh"))
              .select(F.col("i_item_sk").alias("th_item"),
                      F.col("disc_thresh")))
    return (base.join(thresh, on=base["i_item_sk"] == thresh["th_item"])
            .filter(F.col("ws_ext_discount_amt") > F.col("disc_thresh"))
            .agg(F.sum(F.col("ws_ext_discount_amt"))
                 .alias("excess_discount_amount")))


def q96(s, t):
    """Store sales count in a time window (TPC-DS 96)."""
    F = _F()
    ss, td, hd, store = (t["store_sales"], t["time_dim"],
                         t["household_demographics"], t["store"])
    sel_t = td.filter((F.col("t_hour") == 20)
                      & (F.col("t_minute") >= 30))
    sel_hd = hd.filter(F.col("hd_dep_count") == 7)
    return (ss.join(sel_t, on=ss["ss_sold_time_sk"] == sel_t["t_time_sk"])
            .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
            .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
            .agg(F.count_star().alias("cnt")))


def q98(s, t):
    """Store revenue ratio by class over a window (TPC-DS 98)."""
    F = _F()
    from .window import Window
    ss, item, dt = t["store_sales"], t["item"], t["date_dim"]
    sel_i = item.filter(F.col("i_category").isin(
        "Sports", "Books", "Home"))
    days = dt.filter((F.col("d_date") >= F.lit(10371))
                     & (F.col("d_date") <= F.lit(10401)))
    j = (ss.join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"])
         .join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .groupBy("i_item_id", "i_category", "i_class", "i_current_price")
         .agg(F.sum(F.col("ss_ext_sales_price")).alias("itemrevenue")))
    w = Window.partitionBy("i_class")
    return (j.withColumn(
                "revenueratio",
                F.col("itemrevenue") * 100.0
                / F.sum(F.col("itemrevenue")).over(w))
            .select("i_item_id", "i_category", "i_class", "itemrevenue",
                    "revenueratio")
            .sort("i_category", "i_class", "i_item_id")
            .limit(100))


def q99(s, t):
    """Catalog ship-latency day buckets (TPC-DS 99)."""
    F = _F()
    cs, dt, sm, wh = (t["catalog_sales"], t["date_dim"], t["ship_mode"],
                      t["warehouse"])
    months = dt.filter(F.col("d_month_seq").between(350, 361)) \
        .select(F.col("d_date_sk").alias("ship_sk"))
    j = (cs.join(months, on=cs["cs_ship_date_sk"] == months["ship_sk"])
         .join(sm, on=cs["cs_ship_mode_sk"] == sm["sm_ship_mode_sk"])
         .join(wh, on=cs["cs_warehouse_sk"] == wh["w_warehouse_sk"]))
    lag = F.col("cs_ship_date_sk") - F.col("cs_sold_date_sk")
    return (j.groupBy("w_warehouse_name", "sm_type")
            .agg(F.sum(F.when(lag <= 30, 1).otherwise(0)).alias("d30"),
                 F.sum(F.when((lag > 30) & (lag <= 60), 1).otherwise(0))
                 .alias("d31_60"),
                 F.sum(F.when((lag > 60) & (lag <= 90), 1).otherwise(0))
                 .alias("d61_90"),
                 F.sum(F.when((lag > 90) & (lag <= 120), 1).otherwise(0))
                 .alias("d91_120"),
                 F.sum(F.when(lag > 120, 1).otherwise(0)).alias("d_gt120"))
            .sort("w_warehouse_name", "sm_type")
            .limit(100))



def q33_simplified(s, t):
    """Manufacturer revenue across all three channels (TPC-DS 33 shape)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    m = dt.filter((F.col("d_year") == 1998) & (F.col("d_moy") == 3))
    sel_i = item.filter(F.col("i_category") == "Electronics")

    def chan(fact, date_col, item_col, price_col):
        f = t[fact]
        return (f.join(m, on=f[date_col] == m["d_date_sk"])
                .join(sel_i, on=f[item_col] == sel_i["i_item_sk"])
                .groupBy("i_manufact_id")
                .agg(F.sum(F.col(price_col)).alias("total_sales")))

    u = (chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                     "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                     "ws_ext_sales_price")))
    return (u.groupBy("i_manufact_id")
            .agg(F.sum(F.col("total_sales")).alias("total_sales"))
            .sort(F.col("total_sales").desc(), "i_manufact_id")
            .limit(100))


def q45(s, t):
    """Web customers in zip cohort or item cohort (TPC-DS 45)."""
    F = _F()
    ws, cust, ca, dt, item = (t["web_sales"], t["customer"],
                              t["customer_address"], t["date_dim"],
                              t["item"])
    q = dt.filter((F.col("d_qoy") == 2) & (F.col("d_year") == 2001))
    cohort_items = item.filter(F.col("i_item_sk").isin(
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29)) \
        .select(F.col("i_item_id").alias("coh_id")).distinct()
    j = (ws.join(cust, on=ws["ws_bill_customer_sk"]
                 == cust["c_customer_sk"])
         .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"])
         .join(q, on=ws["ws_sold_date_sk"] == q["d_date_sk"])
         .join(item, on=ws["ws_item_sk"] == item["i_item_sk"]))
    zips = ["10000", "10001", "10002", "10003", "10004"]
    cohort = j.join(cohort_items, on=j["i_item_id"]
                    == cohort_items["coh_id"], how="leftsemi") \
        .select("ca_zip", "ca_city", "ws_sales_price")
    zipped = j.filter(F.col("ca_zip").isin(*zips)) \
        .select("ca_zip", "ca_city", "ws_sales_price")
    return (zipped.union(cohort)
            .groupBy("ca_zip", "ca_city")
            .agg(F.sum(F.col("ws_sales_price")).alias("total"))
            .sort("ca_zip", "ca_city")
            .limit(100))


def q88_simplified(s, t):
    """Time-of-day sales histogram (TPC-DS 88 shape: one pass, 8 buckets)."""
    F = _F()
    ss, td, hd = (t["store_sales"], t["time_dim"],
                  t["household_demographics"])
    sel_hd = hd.filter(((F.col("hd_dep_count") == 4)
                        & (F.col("hd_vehicle_count") <= 6))
                       | ((F.col("hd_dep_count") == 2)
                          & (F.col("hd_vehicle_count") <= 4))
                       | ((F.col("hd_dep_count") == 0)
                          & (F.col("hd_vehicle_count") <= 2)))
    j = (ss.join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .join(td, on=ss["ss_sold_time_sk"] == td["t_time_sk"]))
    aggs = []
    for h1, m1, h2, m2, name in [
            (8, 30, 9, 0, "h8_30_to_9"), (9, 0, 9, 30, "h9_to_9_30"),
            (9, 30, 10, 0, "h9_30_to_10"), (10, 0, 10, 30, "h10_to_10_30"),
            (10, 30, 11, 0, "h10_30_to_11"), (11, 0, 11, 30, "h11_to_11_30"),
            (11, 30, 12, 0, "h11_30_to_12"), (12, 0, 12, 30, "h12_to_12_30")]:
        lo = h1 * 60 + m1
        hi = h2 * 60 + m2
        mins = F.col("t_hour") * 60 + F.col("t_minute")
        aggs.append(F.sum(F.when((mins >= lo) & (mins < hi), 1)
                          .otherwise(0)).alias(name))
    return j.agg(*aggs)


# --- round-5 additions: correlated-subquery, set-op, window-chain, and
# grouping-sets families (decorrelated the way Spark's optimizer lowers
# them; reference integration_tests tpcds suites) ---------------------------


def q1(s, t):
    """Customers returning > 1.2x the store average (TPC-DS 1)."""
    F = _F()
    sr, dt, store, cust = (t["store_returns"], t["date_dim"], t["store"],
                           t["customer"])
    y = dt.filter(F.col("d_year") == 2000)
    ctr = (sr.join(y, on=sr["sr_returned_date_sk"] == y["d_date_sk"])
           .groupBy("sr_customer_sk", "sr_store_sk")
           .agg(F.sum(F.col("sr_return_amt")).alias("ctr_total_return")))
    thresh = (ctr.groupBy("sr_store_sk")
              .agg((F.avg(F.col("ctr_total_return")) * 1.2)
                   .alias("ret_thresh"))
              .select(F.col("sr_store_sk").alias("th_store"),
                      F.col("ret_thresh")))
    sel_s = store.filter(F.col("s_state").isin("TN", "CA", "TX", "NY"))
    return (ctr.join(thresh, on=ctr["sr_store_sk"] == thresh["th_store"])
            .filter(F.col("ctr_total_return") > F.col("ret_thresh"))
            .join(sel_s, on=ctr["sr_store_sk"] == sel_s["s_store_sk"])
            .join(cust, on=ctr["sr_customer_sk"] == cust["c_customer_sk"])
            .select("c_customer_id")
            .sort("c_customer_id")
            .limit(100))


def q6(s, t):
    """States where customers buy items priced >1.2x category average
    (TPC-DS 6, decorrelated per-category average)."""
    F = _F()
    ca, cust, ss, dt, item = (t["customer_address"], t["customer"],
                              t["store_sales"], t["date_dim"], t["item"])
    m = dt.filter(F.col("d_year") == 2001)
    cat_avg = (item.groupBy("i_category")
               .agg((F.avg(F.col("i_current_price")) * 1.2)
                    .alias("p_thresh"))
               .select(F.col("i_category").alias("avg_cat"),
                       F.col("p_thresh")))
    pricey = (item.join(cat_avg, on=item["i_category"] == cat_avg["avg_cat"])
              .filter(F.col("i_current_price") > F.col("p_thresh")))
    j = (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
         .join(pricey, on=ss["ss_item_sk"] == pricey["i_item_sk"])
         .join(cust, on=ss["ss_customer_sk"] == cust["c_customer_sk"])
         .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"]))
    return (j.groupBy("ca_state").agg(F.count_star().alias("cnt"))
            .filter(F.col("cnt") >= 10)
            .sort("cnt", "ca_state")
            .limit(100))


def q30(s, t):
    """Web customers returning >1.2x their state average (TPC-DS 30)."""
    F = _F()
    wr, dt, cust, ca = (t["web_returns"], t["date_dim"], t["customer"],
                        t["customer_address"])
    y = dt.filter(F.col("d_year") == 2002)
    base = (wr.join(y, on=wr["wr_returned_date_sk"] == y["d_date_sk"])
            .join(cust, on=wr["wr_returning_customer_sk"]
                  == cust["c_customer_sk"])
            .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"]))
    ctr = (base.groupBy("wr_returning_customer_sk", "ca_state")
           .agg(F.sum(F.col("wr_return_amt")).alias("ctr_total_return")))
    thresh = (ctr.groupBy("ca_state")
              .agg((F.avg(F.col("ctr_total_return")) * 1.2)
                   .alias("ret_thresh"))
              .select(F.col("ca_state").alias("th_state"),
                      F.col("ret_thresh")))
    return (ctr.join(thresh, on=ctr["ca_state"] == thresh["th_state"])
            .filter(F.col("ctr_total_return") > F.col("ret_thresh"))
            .join(cust, on=ctr["wr_returning_customer_sk"]
                  == cust["c_customer_sk"])
            .select("c_customer_id", "c_first_name", "c_last_name",
                    "ca_state", "ctr_total_return")
            .sort("c_customer_id", "ca_state")
            .limit(100))


def q81(s, t):
    """Catalog customers returning >1.2x their state average (TPC-DS 81)."""
    F = _F()
    cr, dt, cust, ca = (t["catalog_returns"], t["date_dim"], t["customer"],
                        t["customer_address"])
    y = dt.filter(F.col("d_year") == 2000)
    base = (cr.join(y, on=cr["cr_returned_date_sk"] == y["d_date_sk"])
            .join(cust, on=cr["cr_returning_customer_sk"]
                  == cust["c_customer_sk"])
            .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"]))
    ctr = (base.groupBy("cr_returning_customer_sk", "ca_state")
           .agg(F.sum(F.col("cr_return_amount")).alias("ctr_total_return")))
    thresh = (ctr.groupBy("ca_state")
              .agg((F.avg(F.col("ctr_total_return")) * 1.2)
                   .alias("ret_thresh"))
              .select(F.col("ca_state").alias("th_state"),
                      F.col("ret_thresh")))
    return (ctr.join(thresh, on=ctr["ca_state"] == thresh["th_state"])
            .filter(F.col("ctr_total_return") > F.col("ret_thresh"))
            .join(cust, on=ctr["cr_returning_customer_sk"]
                  == cust["c_customer_sk"])
            .select("c_customer_id", "c_first_name", "c_last_name",
                    "ca_state", "ctr_total_return")
            .sort("c_customer_id", "ca_state")
            .limit(100))


def q8(s, t):
    """Store profit for zips in both a fixed list and the frequent-customer
    zip set (TPC-DS 8: INTERSECT)."""
    F = _F()
    ss, dt, store, ca, cust = (t["store_sales"], t["date_dim"], t["store"],
                               t["customer_address"], t["customer"])
    zips = [f"{z:05d}" for z in range(10000, 10040)]
    zips1 = (ca.filter(F.col("ca_zip").isin(*zips))
             .select("ca_zip").distinct())
    zips2 = (ca.join(cust, on=ca["ca_address_sk"]
                     == cust["c_current_addr_sk"])
             .groupBy("ca_zip").agg(F.count_star().alias("cnt"))
             .filter(F.col("cnt") > 5).select("ca_zip"))
    sel_zips = zips1.intersect(zips2) \
        .select(F.col("ca_zip").alias("sel_zip"))
    y = dt.filter((F.col("d_qoy") == 2) & (F.col("d_year") == 1998))
    buyer = ca.select(F.col("ca_address_sk").alias("b_addr"),
                      F.col("ca_zip").alias("b_zip"))
    j = (ss.join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(buyer, on=ss["ss_addr_sk"] == buyer["b_addr"])
         .join(sel_zips, on=F.col("b_zip") == sel_zips["sel_zip"],
               how="leftsemi"))
    return (j.groupBy("s_store_name")
            .agg(F.sum(F.col("ss_net_profit")).alias("profit"))
            .sort("s_store_name")
            .limit(100))


def q38(s, t):
    """Customers active in ALL three channels in a period (TPC-DS 38:
    three-way INTERSECT of distinct (name, date) tuples)."""
    F = _F()
    dt, cust = t["date_dim"], t["customer"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))

    def chan(fact, date_col, cust_col):
        f = t[fact]
        return (f.join(period, on=f[date_col] == period["d_date_sk"])
                .join(cust, on=f[cust_col] == cust["c_customer_sk"])
                .select("c_last_name", "c_first_name", "d_date")
                .distinct())

    hot = (chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
           .intersect(chan("catalog_sales", "cs_sold_date_sk",
                           "cs_bill_customer_sk"))
           .intersect(chan("web_sales", "ws_sold_date_sk",
                           "ws_bill_customer_sk")))
    return hot.agg(F.count_star().alias("cnt"))


def q87(s, t):
    """Store-only customers in a period (TPC-DS 87: EXCEPT chain)."""
    F = _F()
    dt, cust = t["date_dim"], t["customer"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))

    def chan(fact, date_col, cust_col):
        f = t[fact]
        return (f.join(period, on=f[date_col] == period["d_date_sk"])
                .join(cust, on=f[cust_col] == cust["c_customer_sk"])
                .select("c_last_name", "c_first_name", "d_date")
                .distinct())

    cool = (chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
            .subtract(chan("catalog_sales", "cs_sold_date_sk",
                           "cs_bill_customer_sk"))
            .subtract(chan("web_sales", "ws_sold_date_sk",
                           "ws_bill_customer_sk")))
    return cool.agg(F.count_star().alias("cnt"))


def q47(s, t):
    """Store brand monthly deviation with prior/next month context
    (TPC-DS 47: window chain — partition avg + lag + lead)."""
    F = _F()
    from .window import Window
    ss, dt, item, store = (t["store_sales"], t["date_dim"], t["item"],
                           t["store"])
    yrs = dt.filter(F.col("d_year").isin(1999, 2000, 2001))
    v1 = (ss.join(yrs, on=ss["ss_sold_date_sk"] == yrs["d_date_sk"])
          .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
          .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
          .groupBy("i_category", "i_brand", "s_store_name", "d_year",
                   "d_moy")
          .agg(F.sum(F.col("ss_sales_price")).alias("sum_sales")))
    w_avg = Window.partitionBy("i_category", "i_brand", "s_store_name",
                               "d_year")
    w_seq = Window.partitionBy("i_category", "i_brand", "s_store_name") \
        .orderBy("d_year", "d_moy")
    v2 = (v1.withColumn("avg_monthly_sales",
                        F.avg(F.col("sum_sales")).over(w_avg))
          .withColumn("psum", F.lag(F.col("sum_sales")).over(w_seq))
          .withColumn("nsum", F.lead(F.col("sum_sales")).over(w_seq)))
    return (v2.filter((F.col("d_year") == 2000)
                      & (F.col("avg_monthly_sales") > 0)
                      & (F.abs(F.col("sum_sales")
                               - F.col("avg_monthly_sales"))
                         / F.col("avg_monthly_sales") > 0.1))
            .select("i_category", "i_brand", "s_store_name", "d_year",
                    "d_moy", "sum_sales", "avg_monthly_sales", "psum",
                    "nsum")
            .sort(F.col("sum_sales") - F.col("avg_monthly_sales"),
                  "s_store_name", "d_moy")
            .limit(100))


def q57(s, t):
    """Catalog brand monthly deviation with prior/next month context
    (TPC-DS 57: q47's window chain on the catalog channel)."""
    F = _F()
    from .window import Window
    cs, dt, item, cc = (t["catalog_sales"], t["date_dim"], t["item"],
                        t["call_center"])
    yrs = dt.filter(F.col("d_year").isin(1999, 2000, 2001))
    v1 = (cs.join(yrs, on=cs["cs_sold_date_sk"] == yrs["d_date_sk"])
          .join(item, on=cs["cs_item_sk"] == item["i_item_sk"])
          .join(cc, on=cs["cs_call_center_sk"] == cc["cc_call_center_sk"])
          .groupBy("i_category", "i_brand", "cc_name", "d_year", "d_moy")
          .agg(F.sum(F.col("cs_sales_price")).alias("sum_sales")))
    w_avg = Window.partitionBy("i_category", "i_brand", "cc_name", "d_year")
    w_seq = Window.partitionBy("i_category", "i_brand", "cc_name") \
        .orderBy("d_year", "d_moy")
    v2 = (v1.withColumn("avg_monthly_sales",
                        F.avg(F.col("sum_sales")).over(w_avg))
          .withColumn("psum", F.lag(F.col("sum_sales")).over(w_seq))
          .withColumn("nsum", F.lead(F.col("sum_sales")).over(w_seq)))
    return (v2.filter((F.col("d_year") == 2000)
                      & (F.col("avg_monthly_sales") > 0)
                      & (F.abs(F.col("sum_sales")
                               - F.col("avg_monthly_sales"))
                         / F.col("avg_monthly_sales") > 0.1))
            .select("i_category", "i_brand", "cc_name", "d_year", "d_moy",
                    "sum_sales", "avg_monthly_sales", "psum", "nsum")
            .sort(F.col("sum_sales") - F.col("avg_monthly_sales"),
                  "cc_name", "d_moy")
            .limit(100))


def q51(s, t):
    """Cumulative web vs store revenue per item (TPC-DS 51: running-sum
    windows + FULL OUTER join)."""
    F = _F()
    from .window import Window
    dt = t["date_dim"]
    period = dt.filter(F.col("d_month_seq").between(350, 355))

    def cume(fact, date_col, item_col, price_col, prefix):
        f = t[fact]
        g = (f.join(period, on=f[date_col] == period["d_date_sk"])
             .groupBy(item_col, "d_date")
             .agg(F.sum(F.col(price_col)).alias("day_sales")))
        w = Window.partitionBy(item_col).orderBy("d_date") \
            .rowsBetween(Window.unboundedPreceding, Window.currentRow)
        return (g.withColumn("cume_sales",
                             F.sum(F.col("day_sales")).over(w))
                .select(F.col(item_col).alias(f"{prefix}_item"),
                        F.col("d_date").alias(f"{prefix}_date"),
                        F.col("cume_sales").alias(f"{prefix}_cume")))

    web = cume("web_sales", "ws_sold_date_sk", "ws_item_sk",
               "ws_sales_price", "w")
    st = cume("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_sales_price", "s")
    j = web.join(st, on=(web["w_item"] == st["s_item"])
                 & (web["w_date"] == st["s_date"]), how="full")
    return (j.withColumn("item_sk", F.coalesce(F.col("w_item"),
                                               F.col("s_item")))
            .withColumn("d_date", F.coalesce(F.col("w_date"),
                                             F.col("s_date")))
            .filter(F.coalesce(F.col("w_cume"), F.lit(0.0))
                    > F.coalesce(F.col("s_cume"), F.lit(0.0)))
            .select("item_sk", "d_date", "w_cume", "s_cume")
            .sort("item_sk", "d_date")
            .limit(100))


def _web_returns_with_site(t, days):
    """Web returns carry no site key — recover ws_web_site_sk by joining
    back to the originating sale on (order, item), the way the standard's
    q5/q77 resolve the web return's site/page."""
    F = _F()
    wr, ws = t["web_returns"], t["web_sales"]
    sale = ws.select(F.col("ws_order_number").alias("o_order"),
                     F.col("ws_item_sk").alias("o_item"),
                     F.col("ws_web_site_sk")).distinct()
    return (wr.join(days, on=wr["wr_returned_date_sk"] == days["d_date_sk"])
            .join(sale, on=(wr["wr_order_number"] == sale["o_order"])
                  & (wr["wr_item_sk"] == sale["o_item"])))


def q5_rollup(s, t):
    """Channel sales/returns/profit ROLLUP (TPC-DS 5: union of sales and
    returns rows per channel, rollup(channel, id))."""
    F = _F()
    dt = t["date_dim"]
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10599)))

    def part(fact, date_col, id_col, sales_col, profit_col, channel):
        f = t[fact]
        return (f.join(days, on=f[date_col] == days["d_date_sk"])
                .select(F.lit(channel).alias("channel"),
                        F.col(id_col).alias("id"),
                        F.col(sales_col).alias("sales"),
                        F.lit(0.0).alias("returns_amt"),
                        F.col(profit_col).alias("profit")))

    def rpart(fact, date_col, id_col, ret_col, loss_col, channel):
        f = t[fact]
        return (f.join(days, on=f[date_col] == days["d_date_sk"])
                .select(F.lit(channel).alias("channel"),
                        F.col(id_col).alias("id"),
                        F.lit(0.0).alias("sales"),
                        F.col(ret_col).alias("returns_amt"),
                        (F.lit(0.0) - F.col(loss_col)).alias("profit")))

    u = (part("store_sales", "ss_sold_date_sk", "ss_store_sk",
              "ss_ext_sales_price", "ss_net_profit", "store channel")
         .union(rpart("store_returns", "sr_returned_date_sk", "sr_store_sk",
                      "sr_return_amt", "sr_net_loss", "store channel"))
         .union(part("catalog_sales", "cs_sold_date_sk",
                     "cs_call_center_sk", "cs_ext_sales_price",
                     "cs_net_profit", "catalog channel"))
         .union(rpart("catalog_returns", "cr_returned_date_sk",
                      "cr_call_center_sk", "cr_return_amount",
                      "cr_net_loss", "catalog channel"))
         .union(part("web_sales", "ws_sold_date_sk", "ws_web_site_sk",
                     "ws_ext_sales_price", "ws_net_profit", "web channel"))
         .union(_web_returns_with_site(t, days).select(
             F.lit("web channel").alias("channel"),
             F.col("ws_web_site_sk").alias("id"),
             F.lit(0.0).alias("sales"),
             F.col("wr_return_amt").alias("returns_amt"),
             (F.lit(0.0) - F.col("wr_net_loss")).alias("profit"))))
    return (u.rollup("channel", "id")
            .agg(F.sum(F.col("sales")).alias("sales"),
                 F.sum(F.col("returns_amt")).alias("returns_amt"),
                 F.sum(F.col("profit")).alias("profit"))
            .sort("channel", "id")
            .limit(100))


def q14_simplified(s, t):
    """Cross-channel items ROLLUP (TPC-DS 14 shape: INTERSECT of item
    attributes across channels feeding a rollup aggregate)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    yrs = dt.filter(F.col("d_year").isin(1999, 2000, 2001))

    def chan_items(fact, date_col, item_col):
        f = t[fact]
        return (f.join(yrs, on=f[date_col] == yrs["d_date_sk"])
                .join(item, on=f[item_col] == item["i_item_sk"])
                .select("i_brand", "i_class", "i_category").distinct())

    cross = (chan_items("store_sales", "ss_sold_date_sk", "ss_item_sk")
             .intersect(chan_items("catalog_sales", "cs_sold_date_sk",
                                   "cs_item_sk"))
             .intersect(chan_items("web_sales", "ws_sold_date_sk",
                                   "ws_item_sk"))
             .select(F.col("i_brand").alias("x_brand"),
                     F.col("i_class").alias("x_class"),
                     F.col("i_category").alias("x_cat")))
    ss = t["store_sales"]
    y2000 = dt.filter(F.col("d_year") == 2000)
    base = (ss.join(y2000, on=ss["ss_sold_date_sk"] == y2000["d_date_sk"])
            .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
            .join(cross, on=(item["i_brand"] == cross["x_brand"])
                  & (item["i_class"] == cross["x_class"])
                  & (item["i_category"] == cross["x_cat"]),
                  how="leftsemi"))
    return (base.rollup("i_category", "i_class", "i_brand")
            .agg(F.sum(F.col("ss_quantity") * F.col("ss_list_price"))
                 .alias("sales"),
                 F.count_star().alias("number_sales"))
            .sort("i_category", "i_class", "i_brand")
            .limit(100))


def q18(s, t):
    """Catalog averages over a geography ROLLUP (TPC-DS 18)."""
    F = _F()
    cs, cd, cust, ca, dt, item = (
        t["catalog_sales"], t["customer_demographics"], t["customer"],
        t["customer_address"], t["date_dim"], t["item"])
    y = dt.filter(F.col("d_year") == 1998)
    sel_cd = cd.filter((F.col("cd_gender") == "F")
                       & (F.col("cd_education_status") == "Unknown"))
    j = (cs.join(y, on=cs["cs_sold_date_sk"] == y["d_date_sk"])
         .join(item, on=cs["cs_item_sk"] == item["i_item_sk"])
         .join(sel_cd, on=cs["cs_bill_cdemo_sk"] == sel_cd["cd_demo_sk"])
         .join(cust, on=cs["cs_bill_customer_sk"] == cust["c_customer_sk"])
         .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"]))
    return (j.rollup("ca_country", "ca_state", "ca_county", "i_item_id")
            .agg(F.avg(F.col("cs_quantity")).alias("agg1"),
                 F.avg(F.col("cs_list_price")).alias("agg2"),
                 F.avg(F.col("cs_coupon_amt")).alias("agg3"),
                 F.avg(F.col("cs_sales_price")).alias("agg4"))
            .sort("ca_country", "ca_state", "ca_county", "i_item_id")
            .limit(100))


def q22(s, t):
    """Inventory quantity-on-hand over the item hierarchy ROLLUP
    (TPC-DS 22)."""
    F = _F()
    inv, dt, item = t["inventory"], t["date_dim"], t["item"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))
    j = (inv.join(period, on=inv["inv_date_sk"] == period["d_date_sk"])
         .join(item, on=inv["inv_item_sk"] == item["i_item_sk"]))
    return (j.rollup("i_category", "i_class", "i_brand", "i_item_id")
            .agg(F.avg(F.col("inv_quantity_on_hand")).alias("qoh"))
            .sort("qoh", "i_category", "i_class", "i_brand", "i_item_id")
            .limit(100))


def q67(s, t):
    """Top items per category over a store/time ROLLUP with a rank window
    (TPC-DS 67)."""
    F = _F()
    from .window import Window
    ss, dt, store, item = (t["store_sales"], t["date_dim"], t["store"],
                           t["item"])
    period = dt.filter(F.col("d_month_seq").between(350, 361))
    g = (ss.join(period, on=ss["ss_sold_date_sk"] == period["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
         .rollup("i_category", "i_class", "i_brand", "d_year", "d_qoy",
                 "d_moy", "s_store_id")
         .agg(F.sum(F.coalesce(F.col("ss_sales_price")
                               * F.col("ss_quantity"), F.lit(0.0)))
              .alias("sumsales")))
    w = Window.partitionBy("i_category").orderBy(F.col("sumsales").desc())
    return (g.withColumn("rk", F.rank().over(w))
            .filter(F.col("rk") <= 10)
            .select("i_category", "i_class", "i_brand", "d_year", "d_qoy",
                    "d_moy", "s_store_id", "sumsales", "rk")
            .sort("i_category", F.col("sumsales").desc(), "rk")
            .limit(100))


def q77(s, t):
    """Per-channel sales vs returns ROLLUP (TPC-DS 77)."""
    F = _F()
    dt = t["date_dim"]
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10615)))

    def sales_by(fact, date_col, id_col, sales_col, profit_col):
        f = t[fact]
        return (f.join(days, on=f[date_col] == days["d_date_sk"])
                .groupBy(id_col)
                .agg(F.sum(F.col(sales_col)).alias("sales"),
                     F.sum(F.col(profit_col)).alias("profit"))
                .select(F.col(id_col).alias("sid"), F.col("sales"),
                        F.col("profit")))

    def returns_by(fact, date_col, id_col, ret_col, loss_col):
        f = t[fact]
        return (f.join(days, on=f[date_col] == days["d_date_sk"])
                .groupBy(id_col)
                .agg(F.sum(F.col(ret_col)).alias("returns_amt"),
                     F.sum(F.col(loss_col)).alias("profit_loss"))
                .select(F.col(id_col).alias("rid"), F.col("returns_amt"),
                        F.col("profit_loss")))

    def channel(sales, rets, name):
        j = sales.join(rets, on=sales["sid"] == rets["rid"], how="left")
        return j.select(
            F.lit(name).alias("channel"), F.col("sid").alias("id"),
            F.col("sales"),
            F.coalesce(F.col("returns_amt"), F.lit(0.0))
            .alias("returns_amt"),
            (F.col("profit")
             - F.coalesce(F.col("profit_loss"), F.lit(0.0)))
            .alias("profit"))

    u = (channel(sales_by("store_sales", "ss_sold_date_sk", "ss_store_sk",
                          "ss_ext_sales_price", "ss_net_profit"),
                 returns_by("store_returns", "sr_returned_date_sk",
                            "sr_store_sk", "sr_return_amt", "sr_net_loss"),
                 "store channel")
         .union(channel(
             sales_by("catalog_sales", "cs_sold_date_sk",
                      "cs_call_center_sk", "cs_ext_sales_price",
                      "cs_net_profit"),
             returns_by("catalog_returns", "cr_returned_date_sk",
                        "cr_call_center_sk", "cr_return_amount",
                        "cr_net_loss"),
             "catalog channel"))
         .union(channel(
             sales_by("web_sales", "ws_sold_date_sk", "ws_web_site_sk",
                      "ws_ext_sales_price", "ws_net_profit"),
             _web_returns_with_site(t, days)
             .groupBy("ws_web_site_sk")
             .agg(F.sum(F.col("wr_return_amt")).alias("returns_amt"),
                  F.sum(F.col("wr_net_loss")).alias("profit_loss"))
             .select(F.col("ws_web_site_sk").alias("rid"),
                     F.col("returns_amt"), F.col("profit_loss")),
             "web channel")))
    return (u.rollup("channel", "id")
            .agg(F.sum(F.col("sales")).alias("sales"),
                 F.sum(F.col("returns_amt")).alias("returns_amt"),
                 F.sum(F.col("profit")).alias("profit"))
            .sort("channel", "id")
            .limit(100))


def q80(s, t):
    """Channel sales net of returns ROLLUP with promo filter (TPC-DS 80:
    sales LEFT OUTER JOIN returns per channel, union, rollup(channel,id))."""
    F = _F()
    dt, item, promo = t["date_dim"], t["item"], t["promotion"]
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10615)))
    sel_i = item.filter(F.col("i_current_price") > 50.0)
    sel_p = promo.filter(F.col("p_channel_tv") == "N")

    def channel(fact, ret, date_col, id_col, item_col, order_col, promo_col,
                price_col, profit_col, r_item, r_order, ret_amt, ret_loss,
                name):
        f, r = t[fact], t[ret]
        rsel = r.select(F.col(r_item).alias("r_item"),
                        F.col(r_order).alias("r_order"),
                        F.col(ret_amt).alias("r_amt"),
                        F.col(ret_loss).alias("r_loss"))
        j = (f.join(days, on=f[date_col] == days["d_date_sk"])
             .join(sel_i, on=f[item_col] == sel_i["i_item_sk"])
             .join(sel_p, on=f[promo_col] == sel_p["p_promo_sk"])
             .join(rsel, on=(f[item_col] == rsel["r_item"])
                   & (f[order_col] == rsel["r_order"]), how="left"))
        return (j.groupBy(id_col)
                .agg(F.sum(F.col(price_col)).alias("sales"),
                     F.sum(F.coalesce(F.col("r_amt"), F.lit(0.0)))
                     .alias("returns_amt"),
                     F.sum(F.col(profit_col)
                           - F.coalesce(F.col("r_loss"), F.lit(0.0)))
                     .alias("profit"))
                .select(F.lit(name).alias("channel"),
                        F.col(id_col).alias("id"), F.col("sales"),
                        F.col("returns_amt"), F.col("profit")))

    u = (channel("store_sales", "store_returns", "ss_sold_date_sk",
                 "ss_store_sk", "ss_item_sk", "ss_ticket_number",
                 "ss_promo_sk", "ss_ext_sales_price", "ss_net_profit",
                 "sr_item_sk", "sr_ticket_number", "sr_return_amt",
                 "sr_net_loss", "store channel")
         .union(channel("catalog_sales", "catalog_returns",
                        "cs_sold_date_sk", "cs_call_center_sk",
                        "cs_item_sk", "cs_order_number", "cs_promo_sk",
                        "cs_ext_sales_price", "cs_net_profit", "cr_item_sk",
                        "cr_order_number", "cr_return_amount", "cr_net_loss",
                        "catalog channel"))
         .union(channel("web_sales", "web_returns", "ws_sold_date_sk",
                        "ws_web_site_sk", "ws_item_sk", "ws_order_number",
                        "ws_promo_sk", "ws_ext_sales_price", "ws_net_profit",
                        "wr_item_sk", "wr_order_number", "wr_return_amt",
                        "wr_net_loss", "web channel")))
    return (u.rollup("channel", "id")
            .agg(F.sum(F.col("sales")).alias("sales"),
                 F.sum(F.col("returns_amt")).alias("returns_amt"),
                 F.sum(F.col("profit")).alias("profit"))
            .sort("channel", "id")
            .limit(100))


def q2(s, t):
    """Week-over-year catalog+web sales ratio by day of week (TPC-DS 2)."""
    F = _F()
    dt, ws, cs = t["date_dim"], t["web_sales"], t["catalog_sales"]
    sales = (ws.select(F.col("ws_sold_date_sk").alias("sold_date_sk"),
                       F.col("ws_ext_sales_price").alias("sales_price"))
             .union(cs.select(
                 F.col("cs_sold_date_sk").alias("sold_date_sk"),
                 F.col("cs_ext_sales_price").alias("sales_price"))))
    j = sales.join(dt, on=sales["sold_date_sk"] == dt["d_date_sk"])
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday"]
    aggs = [F.sum(F.when(F.col("d_day_name") == day, F.col("sales_price"))
                  .otherwise(F.lit(None))).alias(f"{day[:3].lower()}_sales")
            for day in days]
    wk = j.groupBy("d_week_seq").agg(*aggs)
    wk1998 = dt.filter(F.col("d_year") == 1998) \
        .select("d_week_seq").distinct()
    wk1999 = dt.filter(F.col("d_year") == 1999) \
        .select("d_week_seq").distinct()
    y = wk.join(wk1998, on=wk["d_week_seq"] == wk1998["d_week_seq"],
                how="leftsemi")
    z = wk.join(wk1999, on=wk["d_week_seq"] == wk1999["d_week_seq"],
                how="leftsemi") \
        .select((F.col("d_week_seq") - 53).alias("wk2"),
                *[F.col(f"{d[:3].lower()}_sales").alias(
                    f"{d[:3].lower()}_sales2") for d in days])
    jj = y.join(z, on=y["d_week_seq"] == z["wk2"])
    ratios = [F.round(F.col(f"{d[:3].lower()}_sales")
                      / F.col(f"{d[:3].lower()}_sales2"), 2)
              .alias(f"r_{d[:3].lower()}") for d in days]
    return jj.select(F.col("d_week_seq"), *ratios).sort("d_week_seq")


def _year_total(t, fact, date_col, cust_col, amount, year):
    """Per-customer yearly total for the q4/q11/q74 growth family."""
    F = _F()
    f, dt = t[fact], t["date_dim"]
    y = dt.filter(F.col("d_year") == year)
    return (f.join(y, on=f[date_col] == y["d_date_sk"])
            .groupBy(cust_col)
            .agg(F.sum(amount).alias("year_total"))
            .filter(F.col("year_total") > 0))


def q4(s, t):
    """Customers whose catalog AND web growth beat store growth
    (TPC-DS 4: six per-channel year totals joined per customer)."""
    F = _F()
    cust = t["customer"]
    ss_amt = (F.col("ss_ext_list_price") - F.col("ss_ext_wholesale_cost")
              - F.col("ss_ext_discount_amt")
              + F.col("ss_ext_sales_price")) / 2
    cs_amt = (F.col("cs_ext_list_price") - F.col("cs_ext_wholesale_cost")
              - F.col("cs_ext_discount_amt")
              + F.col("cs_ext_sales_price")) / 2
    ws_amt = (F.col("ws_ext_list_price") - F.col("ws_ext_wholesale_cost")
              - F.col("ws_ext_discount_amt")
              + F.col("ws_ext_sales_price")) / 2

    def yt(fact, date_col, cust_col, amt, year, name):
        return _year_total(t, fact, date_col, cust_col, amt, year) \
            .select(F.col(cust_col).alias(f"{name}_cust"),
                    F.col("year_total").alias(name))

    ss1 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk", ss_amt,
             1999, "ss1")
    ss2 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk", ss_amt,
             2000, "ss2")
    cs1 = yt("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
             cs_amt, 1999, "cs1")
    cs2 = yt("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
             cs_amt, 2000, "cs2")
    ws1 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", ws_amt,
             1999, "ws1")
    ws2 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", ws_amt,
             2000, "ws2")
    j = (ss1.join(ss2, on=ss1["ss1_cust"] == ss2["ss2_cust"])
         .join(cs1, on=ss1["ss1_cust"] == cs1["cs1_cust"])
         .join(cs2, on=ss1["ss1_cust"] == cs2["cs2_cust"])
         .join(ws1, on=ss1["ss1_cust"] == ws1["ws1_cust"])
         .join(ws2, on=ss1["ss1_cust"] == ws2["ws2_cust"]))
    j = j.filter((F.col("cs2") / F.col("cs1") > F.col("ss2") / F.col("ss1"))
                 & (F.col("cs2") / F.col("cs1")
                    > F.col("ws2") / F.col("ws1")))
    return (j.join(cust, on=j["ss1_cust"] == cust["c_customer_sk"])
            .select("c_customer_id", "c_first_name", "c_last_name")
            .sort("c_customer_id")
            .limit(100))


def q9(s, t):
    """Quantity-bucketed conditional averages off a one-row reason probe
    (TPC-DS 9: CASE over cross-joined scalar aggregates)."""
    F = _F()
    ss, reason = t["store_sales"], t["reason"]
    buckets = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    aggs = []
    for i, (lo, hi) in enumerate(buckets, 1):
        inb = F.col("ss_quantity").between(lo, hi)
        aggs += [
            F.sum(F.when(inb, 1).otherwise(0)).alias(f"cnt{i}"),
            F.avg(F.when(inb, F.col("ss_ext_discount_amt"))
                  .otherwise(F.lit(None))).alias(f"avg_disc{i}"),
            F.avg(F.when(inb, F.col("ss_net_paid"))
                  .otherwise(F.lit(None))).alias(f"avg_paid{i}"),
        ]
    stats = ss.agg(*aggs)
    probe = reason.filter(F.col("r_reason_sk") == 1).select("r_reason_sk")
    out = probe.crossJoin(stats)
    cases = [F.when(F.col(f"cnt{i}") > 100 * i,
                    F.col(f"avg_disc{i}"))
             .otherwise(F.col(f"avg_paid{i}")).alias(f"bucket{i}")
             for i in range(1, 6)]
    return out.select(*cases)


def q10(s, t):
    """Demographic counts for county customers active in store AND
    (web OR catalog) channels (TPC-DS 10: EXISTS lowered to semi joins)."""
    F = _F()
    cust, ca, cd, dt = (t["customer"], t["customer_address"],
                        t["customer_demographics"], t["date_dim"])
    period = dt.filter((F.col("d_year") == 2000)
                       & F.col("d_moy").between(1, 4))
    ss_cust = (t["store_sales"]
               .join(period, on=t["store_sales"]["ss_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ss_customer_sk").alias("a_cust")).distinct())
    ws_cust = (t["web_sales"]
               .join(period, on=t["web_sales"]["ws_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ws_bill_customer_sk").alias("a_cust")))
    cs_cust = (t["catalog_sales"]
               .join(period, on=t["catalog_sales"]["cs_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("cs_bill_customer_sk").alias("a_cust")))
    other = ws_cust.union(cs_cust).distinct()
    sel_ca = ca.filter(F.col("ca_county").isin("county0", "county1",
                                               "county2", "county3",
                                               "county4"))
    j = (cust.join(ss_cust, on=cust["c_customer_sk"] == ss_cust["a_cust"],
                   how="leftsemi")
         .join(other, on=cust["c_customer_sk"] == other["a_cust"],
               how="leftsemi")
         .join(sel_ca, on=cust["c_current_addr_sk"]
               == sel_ca["ca_address_sk"])
         .join(cd, on=cust["c_current_cdemo_sk"] == cd["cd_demo_sk"]))
    return (j.groupBy("cd_gender", "cd_marital_status",
                      "cd_education_status")
            .agg(F.count_star().alias("cnt"),
                 F.min(F.col("cd_purchase_estimate")).alias("min_est"),
                 F.max(F.col("cd_purchase_estimate")).alias("max_est"),
                 F.avg(F.col("cd_purchase_estimate")).alias("avg_est"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status")
            .limit(100))


def q11(s, t):
    """Customers whose web growth beats store growth (TPC-DS 11)."""
    F = _F()
    cust = t["customer"]
    ss_amt = F.col("ss_ext_list_price") - F.col("ss_ext_discount_amt")
    ws_amt = F.col("ws_ext_list_price") - F.col("ws_ext_discount_amt")

    def yt(fact, date_col, cust_col, amt, year, name):
        return _year_total(t, fact, date_col, cust_col, amt, year) \
            .select(F.col(cust_col).alias(f"{name}_cust"),
                    F.col("year_total").alias(name))

    ss1 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk", ss_amt,
             1999, "ss1")
    ss2 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk", ss_amt,
             2000, "ss2")
    ws1 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", ws_amt,
             1999, "ws1")
    ws2 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk", ws_amt,
             2000, "ws2")
    j = (ss1.join(ss2, on=ss1["ss1_cust"] == ss2["ss2_cust"])
         .join(ws1, on=ss1["ss1_cust"] == ws1["ws1_cust"])
         .join(ws2, on=ss1["ss1_cust"] == ws2["ws2_cust"])
         .filter(F.col("ws2") / F.col("ws1")
                 > F.col("ss2") / F.col("ss1")))
    return (j.join(cust, on=j["ss1_cust"] == cust["c_customer_sk"])
            .select("c_customer_id", "c_first_name", "c_last_name")
            .sort("c_customer_id")
            .limit(100))


def q16(s, t):
    """Multi-warehouse catalog orders never returned (TPC-DS 16:
    EXISTS/NOT EXISTS + COUNT DISTINCT via two-phase dedup)."""
    F = _F()
    cs, cr, dt, cc = (t["catalog_sales"], t["catalog_returns"],
                      t["date_dim"], t["call_center"])
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10645)))
    multi_wh = (t["catalog_sales"]
                .select("cs_order_number", "cs_warehouse_sk").distinct()
                .groupBy("cs_order_number")
                .agg(F.count_star().alias("n_wh"))
                .filter(F.col("n_wh") > 1)
                .select(F.col("cs_order_number").alias("mw_order")))
    base = (cs.join(days, on=cs["cs_ship_date_sk"] == days["d_date_sk"])
            .join(cc, on=cs["cs_call_center_sk"] == cc["cc_call_center_sk"])
            .join(multi_wh, on=cs["cs_order_number"] == multi_wh["mw_order"],
                  how="leftsemi")
            .join(cr.select(F.col("cr_order_number").alias("r_order")),
                  on=cs["cs_order_number"] == F.col("r_order"),
                  how="leftanti"))
    orders = (base.select("cs_order_number").distinct()
              .agg(F.count_star().alias("order_count")))
    money = base.agg(F.sum(F.col("cs_ext_tax")).alias("total_tax"),
                     F.sum(F.col("cs_net_profit")).alias("total_profit"))
    return orders.crossJoin(money)


def q17(s, t):
    """Quantity statistics across the sale→return→repurchase chain
    (TPC-DS 17: three date roles, avg/stddev per item and state)."""
    F = _F()
    ss, sr, cs, dt, store, item = (
        t["store_sales"], t["store_returns"], t["catalog_sales"],
        t["date_dim"], t["store"], t["item"])
    # year-wide date roles: the standard's quarter windows select almost
    # nothing at the suite's toy scale (the repurchase join is already the
    # selective step)
    d1 = dt.filter(F.col("d_year") == 2000) \
        .select(F.col("d_date_sk").alias("d1_sk"))
    d2 = dt.filter(F.col("d_year").between(1998, 2004)) \
        .select(F.col("d_date_sk").alias("d2_sk"))
    d3 = dt.filter(F.col("d_year").between(1998, 2004)) \
        .select(F.col("d_date_sk").alias("d3_sk"))
    j = (ss.join(sr, on=(ss["ss_ticket_number"] == sr["sr_ticket_number"])
                 & (ss["ss_item_sk"] == sr["sr_item_sk"])
                 & (ss["ss_customer_sk"] == sr["sr_customer_sk"]))
         .join(cs, on=(sr["sr_customer_sk"] == cs["cs_bill_customer_sk"])
               & (sr["sr_item_sk"] == cs["cs_item_sk"]))
         .join(d1, on=ss["ss_sold_date_sk"] == F.col("d1_sk"))
         .join(d2, on=sr["sr_returned_date_sk"] == F.col("d2_sk"))
         .join(d3, on=cs["cs_sold_date_sk"] == F.col("d3_sk"))
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"]))
    return (j.groupBy("i_item_id", "s_state")
            .agg(F.count(F.col("ss_quantity")).alias("store_sales_cnt"),
                 F.avg(F.col("ss_quantity")).alias("store_sales_avg"),
                 F.stddev(F.col("ss_quantity")).alias("store_sales_stdev"),
                 F.count(F.col("sr_return_quantity"))
                 .alias("store_ret_cnt"),
                 F.avg(F.col("sr_return_quantity")).alias("store_ret_avg"),
                 F.count(F.col("cs_quantity")).alias("catalog_cnt"),
                 F.avg(F.col("cs_quantity")).alias("catalog_avg"))
            .sort("i_item_id", "s_state")
            .limit(100))


def q21(s, t):
    """Inventory shift around a pivot date per warehouse/item
    (TPC-DS 21)."""
    F = _F()
    inv, wh, item, dt = (t["inventory"], t["warehouse"], t["item"],
                         t["date_dim"])
    # wider window + looser ratio than the standard: inventory is sparse
    # per (warehouse,item) at suite scale, the shape is what's exercised
    pivot = 10600
    days = dt.filter((F.col("d_date") >= F.lit(pivot - 120))
                     & (F.col("d_date") <= F.lit(pivot + 120)))
    sel_i = item.filter(F.col("i_current_price").between(0.99, 150.0))
    j = (inv.join(days, on=inv["inv_date_sk"] == days["d_date_sk"])
         .join(sel_i, on=inv["inv_item_sk"] == sel_i["i_item_sk"])
         .join(wh, on=inv["inv_warehouse_sk"] == wh["w_warehouse_sk"]))
    g = (j.groupBy("w_warehouse_name", "i_item_id")
         .agg(F.sum(F.when(F.col("d_date") < pivot,
                           F.col("inv_quantity_on_hand")).otherwise(0))
              .alias("inv_before"),
              F.sum(F.when(F.col("d_date") >= pivot,
                           F.col("inv_quantity_on_hand")).otherwise(0))
              .alias("inv_after")))
    return (g.filter((F.col("inv_before") > 0)
                     & (F.col("inv_after") / F.col("inv_before") >= 1.0 / 3)
                     & (F.col("inv_after") / F.col("inv_before") <= 3.0))
            .select("w_warehouse_name", "i_item_id", "inv_before",
                    "inv_after")
            .sort("w_warehouse_name", "i_item_id")
            .limit(100))


def q23_simplified(s, t):
    """Catalog+web sales to best customers on frequent items (TPC-DS 23
    shape: two derived cohorts feeding semi joins)."""
    F = _F()
    dt, ss = t["date_dim"], t["store_sales"]
    yrs = dt.filter(F.col("d_year").isin(1999, 2000))
    frequent = (ss.join(yrs, on=ss["ss_sold_date_sk"] == yrs["d_date_sk"])
                .groupBy("ss_item_sk")
                .agg(F.count_star().alias("cnt"))
                .filter(F.col("cnt") > 4)
                .select(F.col("ss_item_sk").alias("f_item")))
    spend = (ss.groupBy("ss_customer_sk")
             .agg(F.sum(F.col("ss_quantity") * F.col("ss_sales_price"))
                  .alias("csales")))
    tpcds_max = spend.agg(F.max(F.col("csales")).alias("tpcds_cmax"))
    best = (spend.crossJoin(tpcds_max)
            .filter(F.col("csales") > 0.5 * F.col("tpcds_cmax"))
            .select(F.col("ss_customer_sk").alias("b_cust")))
    month = dt.filter((F.col("d_year") == 2000) & (F.col("d_moy") == 3))
    cs, ws = t["catalog_sales"], t["web_sales"]
    cs_part = (cs.join(month, on=cs["cs_sold_date_sk"] == month["d_date_sk"])
               .join(frequent, on=cs["cs_item_sk"] == frequent["f_item"],
                     how="leftsemi")
               .join(best, on=cs["cs_bill_customer_sk"] == best["b_cust"],
                     how="leftsemi")
               .select((F.col("cs_quantity") * F.col("cs_list_price"))
                       .alias("sales")))
    ws_part = (ws.join(month, on=ws["ws_sold_date_sk"] == month["d_date_sk"])
               .join(frequent, on=ws["ws_item_sk"] == frequent["f_item"],
                     how="leftsemi")
               .join(best, on=ws["ws_bill_customer_sk"] == best["b_cust"],
                     how="leftsemi")
               .select((F.col("ws_quantity") * F.col("ws_list_price"))
                       .alias("sales")))
    return cs_part.union(ws_part).agg(F.sum(F.col("sales")).alias("sales"))


def q24_simplified(s, t):
    """Returned-sale net paid per customer and item color vs a global
    threshold (TPC-DS 24 shape)."""
    F = _F()
    ss, sr, store, item, cust = (t["store_sales"], t["store_returns"],
                                 t["store"], t["item"], t["customer"])
    j = (ss.join(sr, on=(ss["ss_ticket_number"] == sr["sr_ticket_number"])
                 & (ss["ss_item_sk"] == sr["sr_item_sk"]))
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(item, on=ss["ss_item_sk"] == item["i_item_sk"])
         .join(cust, on=ss["ss_customer_sk"] == cust["c_customer_sk"]))
    g = (j.groupBy("c_last_name", "c_first_name", "s_store_name",
                   "i_color")
         .agg(F.sum(F.col("ss_net_paid")).alias("netpaid")))
    thresh = g.agg((F.avg(F.col("netpaid")) * 0.05).alias("paid_thresh"))
    return (g.crossJoin(thresh)
            .filter(F.col("netpaid") > F.col("paid_thresh"))
            .select("c_last_name", "c_first_name", "s_store_name",
                    "netpaid")
            .sort("c_last_name", "c_first_name", "s_store_name")
            .limit(100))


def q28(s, t):
    """Six list-price bucket profiles with distinct counts (TPC-DS 28:
    cross-joined scalar aggregates, COUNT DISTINCT two-phase)."""
    F = _F()
    ss = t["store_sales"]
    buckets = [(0, 5, 8.0, 108.0), (6, 10, 90.0, 190.0),
               (11, 15, 142.0, 242.0), (16, 20, 135.0, 235.0),
               (21, 25, 122.0, 222.0), (26, 30, 154.0, 254.0)]
    out = None
    for i, (qlo, qhi, plo, phi) in enumerate(buckets, 1):
        f = ss.filter(F.col("ss_quantity").between(qlo, qhi)
                      & (F.col("ss_list_price").between(plo, phi)
                         | F.col("ss_coupon_amt").between(plo, phi + 800)
                         | F.col("ss_wholesale_cost").between(plo - 60,
                                                              phi - 30)))
        stats = f.agg(F.avg(F.col("ss_list_price")).alias(f"b{i}_lp"),
                      F.count(F.col("ss_list_price")).alias(f"b{i}_cnt"))
        dcnt = (f.select("ss_list_price").distinct()
                .agg(F.count_star().alias(f"b{i}_cntd")))
        piece = stats.crossJoin(dcnt)
        out = piece if out is None else out.crossJoin(piece)
    return out


def q31(s, t):
    """County store-vs-web quarterly growth comparison (TPC-DS 31)."""
    F = _F()
    dt, ca = t["date_dim"], t["customer_address"]

    def qsum(fact, date_col, addr_col, price_col, qoy, name):
        f = t[fact]
        d = dt.filter((F.col("d_qoy") == qoy) & (F.col("d_year") == 2000))
        return (f.join(d, on=f[date_col] == d["d_date_sk"])
                .join(ca, on=f[addr_col] == ca["ca_address_sk"])
                .groupBy("ca_county")
                .agg(F.sum(F.col(price_col)).alias(name))
                .select(F.col("ca_county").alias(f"{name}_cty"),
                        F.col(name)))

    ss1 = qsum("store_sales", "ss_sold_date_sk", "ss_addr_sk",
               "ss_ext_sales_price", 1, "ss1")
    ss2 = qsum("store_sales", "ss_sold_date_sk", "ss_addr_sk",
               "ss_ext_sales_price", 2, "ss2")
    ss3 = qsum("store_sales", "ss_sold_date_sk", "ss_addr_sk",
               "ss_ext_sales_price", 3, "ss3")
    ws1 = qsum("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
               "ws_ext_sales_price", 1, "ws1")
    ws2 = qsum("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
               "ws_ext_sales_price", 2, "ws2")
    ws3 = qsum("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
               "ws_ext_sales_price", 3, "ws3")
    j = (ss1.join(ss2, on=ss1["ss1_cty"] == ss2["ss2_cty"])
         .join(ss3, on=ss1["ss1_cty"] == ss3["ss3_cty"])
         .join(ws1, on=ss1["ss1_cty"] == ws1["ws1_cty"])
         .join(ws2, on=ss1["ss1_cty"] == ws2["ws2_cty"])
         .join(ws3, on=ss1["ss1_cty"] == ws3["ws3_cty"]))
    return (j.filter((F.col("ws2") / F.col("ws1")
                      > F.col("ss2") / F.col("ss1"))
                     & (F.col("ws3") / F.col("ws2")
                        > F.col("ss3") / F.col("ss2")))
            .select(F.col("ss1_cty").alias("ca_county"),
                    (F.col("ws2") / F.col("ws1")).alias("web_q1_q2"),
                    (F.col("ss2") / F.col("ss1")).alias("store_q1_q2"))
            .sort("ca_county"))


def q34(s, t):
    """Households buying 2-4 tickets in the dom windows (TPC-DS 34)."""
    F = _F()
    ss, dt, store, hd, cust = (t["store_sales"], t["date_dim"], t["store"],
                               t["household_demographics"], t["customer"])
    days = dt.filter((F.col("d_dom").between(1, 3)
                      | F.col("d_dom").between(25, 28))
                     & F.col("d_year").isin(1999, 2000, 2001))
    sel_hd = hd.filter(F.col("hd_buy_potential").isin(">10000", "Unknown")
                       & (F.col("hd_vehicle_count") > 0))
    g = (ss.join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .groupBy("ss_ticket_number", "ss_customer_sk")
         .agg(F.count_star().alias("cnt"))
         .filter(F.col("cnt").between(2, 4)))
    return (g.join(cust, on=g["ss_customer_sk"] == cust["c_customer_sk"])
            .select("c_last_name", "c_first_name", "ss_ticket_number",
                    "cnt")
            .sort(F.col("cnt").desc(), "c_last_name")
            .limit(100))


def q35(s, t):
    """Demographics of multi-channel buyers (TPC-DS 35)."""
    F = _F()
    cust, ca, cd, dt = (t["customer"], t["customer_address"],
                        t["customer_demographics"], t["date_dim"])
    period = dt.filter((F.col("d_year") == 2000)
                       & (F.col("d_qoy") < 4))
    ss_cust = (t["store_sales"]
               .join(period, on=t["store_sales"]["ss_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ss_customer_sk").alias("a_cust")).distinct())
    ws_cust = (t["web_sales"]
               .join(period, on=t["web_sales"]["ws_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ws_bill_customer_sk").alias("a_cust")))
    cs_cust = (t["catalog_sales"]
               .join(period, on=t["catalog_sales"]["cs_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("cs_bill_customer_sk").alias("a_cust")))
    other = ws_cust.union(cs_cust).distinct()
    j = (cust.join(ss_cust, on=cust["c_customer_sk"] == ss_cust["a_cust"],
                   how="leftsemi")
         .join(other, on=cust["c_customer_sk"] == other["a_cust"],
               how="leftsemi")
         .join(ca, on=cust["c_current_addr_sk"] == ca["ca_address_sk"])
         .join(cd, on=cust["c_current_cdemo_sk"] == cd["cd_demo_sk"]))
    return (j.groupBy("ca_state", "cd_gender", "cd_marital_status")
            .agg(F.count_star().alias("cnt"),
                 F.min(F.col("cd_dep_count")).alias("min_dep"),
                 F.max(F.col("cd_dep_count")).alias("max_dep"),
                 F.avg(F.col("cd_dep_count")).alias("avg_dep"))
            .sort("ca_state", "cd_gender", "cd_marital_status")
            .limit(100))


def q39(s, t):
    """Inventory variability month-over-month (TPC-DS 39: stdev/mean
    coefficient joined across adjacent months)."""
    F = _F()
    inv, dt, item, wh = (t["inventory"], t["date_dim"], t["item"],
                         t["warehouse"])
    y = dt.filter(F.col("d_year") == 2000)
    # warehouse/month grain (the standard's per-item grain has singleton
    # groups at suite scale, so sample stddev would be null everywhere);
    # uniform qoh gives cov≈0.58, so the standard's cov>1 would select
    # nothing — 0.5 keeps the same shape with live rows
    g = (inv.join(y, on=inv["inv_date_sk"] == y["d_date_sk"])
         .join(item, on=inv["inv_item_sk"] == item["i_item_sk"])
         .join(wh, on=inv["inv_warehouse_sk"] == wh["w_warehouse_sk"])
         .groupBy("w_warehouse_sk", "d_moy")
         .agg(F.stddev(F.col("inv_quantity_on_hand")).alias("stdev"),
              F.avg(F.col("inv_quantity_on_hand")).alias("mean")))
    g = (g.filter((F.col("mean") > 0)
                  & (F.col("stdev") / F.col("mean") > 0.5))
         .withColumn("cov", F.col("stdev") / F.col("mean")))
    m1 = g.filter(F.col("d_moy") == 1).select(
        F.col("w_warehouse_sk").alias("w1"), F.col("cov").alias("cov1"))
    m2 = g.filter(F.col("d_moy") == 2).select(
        F.col("w_warehouse_sk").alias("w2"), F.col("cov").alias("cov2"))
    return (m1.join(m2, on=m1["w1"] == m2["w2"])
            .select("w1", "cov1", "cov2")
            .sort("w1"))


def q40(s, t):
    """Catalog sales net of returns around a pivot date per warehouse state
    (TPC-DS 40)."""
    F = _F()
    cs, cr, wh, item, dt = (t["catalog_sales"], t["catalog_returns"],
                            t["warehouse"], t["item"], t["date_dim"])
    pivot = 10600
    days = dt.filter((F.col("d_date") >= F.lit(pivot - 30))
                     & (F.col("d_date") <= F.lit(pivot + 30)))
    sel_i = item.filter(F.col("i_current_price").between(0.99, 150.0))
    rsel = cr.select(F.col("cr_item_sk").alias("r_item"),
                     F.col("cr_order_number").alias("r_order"),
                     F.col("cr_return_amount").alias("r_amt"))
    j = (cs.join(days, on=cs["cs_sold_date_sk"] == days["d_date_sk"])
         .join(sel_i, on=cs["cs_item_sk"] == sel_i["i_item_sk"])
         .join(wh, on=cs["cs_warehouse_sk"] == wh["w_warehouse_sk"])
         .join(rsel, on=(cs["cs_item_sk"] == rsel["r_item"])
               & (cs["cs_order_number"] == rsel["r_order"]), how="left"))
    net = F.col("cs_sales_price") - F.coalesce(F.col("r_amt"), F.lit(0.0))
    return (j.groupBy("w_state", "i_item_id")
            .agg(F.sum(F.when(F.col("d_date") < pivot, net).otherwise(0.0))
                 .alias("sales_before"),
                 F.sum(F.when(F.col("d_date") >= pivot, net).otherwise(0.0))
                 .alias("sales_after"))
            .sort("w_state", "i_item_id")
            .limit(100))


def q41(s, t):
    """Distinct items of manufacturers with qualifying variants
    (TPC-DS 41: EXISTS over the item dimension itself)."""
    F = _F()
    item = t["item"]
    variants = (item.filter(
        F.col("i_color").isin("almond", "antique", "aquamarine", "azure",
                              "beige", "blue", "blush", "brown")
        & F.col("i_size").isin("small", "medium", "large"))
        .select(F.col("i_manufact_id").alias("v_manufact")).distinct())
    sel = item.filter(F.col("i_manufact_id").between(1, 500))
    return (sel.join(variants, on=sel["i_manufact_id"]
                     == variants["v_manufact"], how="leftsemi")
            .select("i_item_id").distinct()
            .sort("i_item_id")
            .limit(100))


def q44(s, t):
    """Best and worst items by store profit rank (TPC-DS 44: dual rank
    windows joined on rank)."""
    F = _F()
    from .window import Window
    ss, item = t["store_sales"], t["item"]
    base = (ss.filter(F.col("ss_store_sk") == 4)
            .groupBy("ss_item_sk")
            .agg(F.avg(F.col("ss_net_profit")).alias("rank_col")))
    asc = (base.withColumn(
        "rnk", F.rank().over(Window.orderBy(F.col("rank_col").asc())))
        .filter(F.col("rnk") <= 10)
        .select(F.col("rnk").alias("a_rnk"),
                F.col("ss_item_sk").alias("best_sk")))
    desc = (base.withColumn(
        "rnk", F.rank().over(Window.orderBy(F.col("rank_col").desc())))
        .filter(F.col("rnk") <= 10)
        .select(F.col("rnk").alias("d_rnk"),
                F.col("ss_item_sk").alias("worst_sk")))
    i1 = item.select(F.col("i_item_sk").alias("i1_sk"),
                     F.col("i_item_id").alias("best_performing"))
    i2 = item.select(F.col("i_item_sk").alias("i2_sk"),
                     F.col("i_item_id").alias("worst_performing"))
    return (asc.join(desc, on=asc["a_rnk"] == desc["d_rnk"])
            .join(i1, on=F.col("best_sk") == i1["i1_sk"])
            .join(i2, on=F.col("worst_sk") == i2["i2_sk"])
            .select(F.col("a_rnk").alias("rnk"), "best_performing",
                    "worst_performing")
            .sort("rnk"))


def q46(s, t):
    """Weekend city purchases by mobile households (TPC-DS 46)."""
    F = _F()
    ss, dt, store, hd, ca, cust = (t["store_sales"], t["date_dim"],
                                   t["store"], t["household_demographics"],
                                   t["customer_address"], t["customer"])
    days = dt.filter(F.col("d_dow").isin(6, 0)
                     & F.col("d_year").isin(1999, 2000, 2001))
    sel_hd = hd.filter((F.col("hd_dep_count") == 4)
                       | (F.col("hd_vehicle_count") == 3))
    sel_ca = ca.select(F.col("ca_address_sk").alias("pos_addr"),
                       F.col("ca_city").alias("bought_city"))
    g = (ss.join(days, on=ss["ss_sold_date_sk"] == days["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(sel_hd, on=ss["ss_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .join(sel_ca, on=ss["ss_addr_sk"] == sel_ca["pos_addr"])
         .groupBy("ss_ticket_number", "ss_customer_sk", "bought_city")
         .agg(F.sum(F.col("ss_coupon_amt")).alias("amt"),
              F.sum(F.col("ss_net_profit")).alias("profit")))
    j = (g.join(cust, on=g["ss_customer_sk"] == cust["c_customer_sk"])
         .join(t["customer_address"],
               on=cust["c_current_addr_sk"]
               == t["customer_address"]["ca_address_sk"])
         .filter(F.col("ca_city") != F.col("bought_city")))
    return (j.select("c_last_name", "c_first_name", "ca_city",
                     "bought_city", "ss_ticket_number", "amt", "profit")
            .sort("c_last_name", "c_first_name", "ss_ticket_number")
            .limit(100))


def q49(s, t):
    """Worst return ratios per channel (TPC-DS 49: dual rank windows per
    channel, union)."""
    F = _F()
    from .window import Window
    dt = t["date_dim"]
    period = dt.filter((F.col("d_year") == 2000) & (F.col("d_moy") == 12))

    def chan(fact, ret, date_col, item_col, order_col, qty_col, price_col,
             r_item, r_order, r_qty, r_amt, name):
        f, r = t[fact], t[ret]
        rsel = r.select(F.col(r_item).alias("r_item"),
                        F.col(r_order).alias("r_order"),
                        F.col(r_qty).alias("r_qty"),
                        F.col(r_amt).alias("r_amt"))
        j = (f.join(period, on=f[date_col] == period["d_date_sk"])
             .filter((F.col(qty_col) > 0) & (F.col(price_col) > 0))
             .join(rsel, on=(f[item_col] == rsel["r_item"])
                   & (f[order_col] == rsel["r_order"]), how="left"))
        g = (j.groupBy(item_col)
             .agg(F.sum(F.coalesce(F.col("r_qty"), F.lit(0)))
                  .alias("ret_qty"),
                  F.sum(F.col(qty_col)).alias("sold_qty"),
                  F.sum(F.coalesce(F.col("r_amt"), F.lit(0.0)))
                  .alias("ret_amt"),
                  F.sum(F.col(price_col) * F.col(qty_col))
                  .alias("sold_amt")))
        g = (g.withColumn("return_ratio",
                          F.col("ret_qty") / F.col("sold_qty"))
             .withColumn("currency_ratio",
                         F.col("ret_amt") / F.col("sold_amt")))
        g = (g.withColumn("return_rank", F.rank().over(
                Window.orderBy(F.col("return_ratio").asc())))
             .withColumn("currency_rank", F.rank().over(
                 Window.orderBy(F.col("currency_ratio").asc()))))
        return (g.filter((F.col("return_rank") <= 10)
                         | (F.col("currency_rank") <= 10))
                .select(F.lit(name).alias("channel"),
                        F.col(item_col).cast("long").alias("item"),
                        F.col("return_ratio"), F.col("return_rank"),
                        F.col("currency_rank")))

    u = (chan("web_sales", "web_returns", "ws_sold_date_sk", "ws_item_sk",
              "ws_order_number", "ws_quantity", "ws_sales_price",
              "wr_item_sk", "wr_order_number", "wr_return_quantity",
              "wr_return_amt", "web")
         .union(chan("catalog_sales", "catalog_returns", "cs_sold_date_sk",
                     "cs_item_sk", "cs_order_number", "cs_quantity",
                     "cs_sales_price", "cr_item_sk", "cr_order_number",
                     "cr_return_quantity", "cr_return_amount", "catalog"))
         .union(chan("store_sales", "store_returns", "ss_sold_date_sk",
                     "ss_item_sk", "ss_ticket_number", "ss_quantity",
                     "ss_sales_price", "sr_item_sk", "sr_ticket_number",
                     "sr_return_quantity", "sr_return_amt", "store")))
    return (u.sort("channel", "return_rank", "item")
            .limit(100))


def q54(s, t):
    """Revenue segments of a month's cross-channel Electronics cohort
    (TPC-DS 54)."""
    F = _F()
    dt, item, cust, ss = (t["date_dim"], t["item"], t["customer"],
                          t["store_sales"])
    month = dt.filter((F.col("d_year") == 2000) & (F.col("d_moy") == 3))
    sel_i = item.filter(F.col("i_category") == "Electronics")
    cs, ws = t["catalog_sales"], t["web_sales"]
    sales = (cs.select(F.col("cs_sold_date_sk").alias("sold_date_sk"),
                       F.col("cs_bill_customer_sk").alias("cust_sk"),
                       F.col("cs_item_sk").alias("item_sk"))
             .union(ws.select(
                 F.col("ws_sold_date_sk").alias("sold_date_sk"),
                 F.col("ws_bill_customer_sk").alias("cust_sk"),
                 F.col("ws_item_sk").alias("item_sk"))))
    cohort = (sales.join(month, on=sales["sold_date_sk"]
                         == month["d_date_sk"])
              .join(sel_i, on=sales["item_sk"] == sel_i["i_item_sk"])
              .select("cust_sk").distinct())
    following = dt.filter((F.col("d_year") == 2000)
                          & F.col("d_moy").between(4, 6))
    rev = (ss.join(cohort, on=ss["ss_customer_sk"] == cohort["cust_sk"],
                   how="leftsemi")
           .join(following, on=ss["ss_sold_date_sk"]
                 == following["d_date_sk"])
           .groupBy("ss_customer_sk")
           .agg(F.sum(F.col("ss_ext_sales_price")).alias("revenue")))
    seg = rev.withColumn("segment",
                         F.floor(F.col("revenue") / 50).cast("int"))
    return (seg.groupBy("segment")
            .agg(F.count_star().alias("num_customers"))
            .withColumn("segment_base", F.col("segment") * 50)
            .sort("segment", "num_customers")
            .limit(100))


def q56(s, t):
    """Colored-item revenue across all three channels (TPC-DS 56)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    m = dt.filter((F.col("d_year") == 2000) & (F.col("d_moy") == 2))
    sel_i = item.filter(F.col("i_color").isin("almond", "azure", "blue",
                                              "brown", "beige"))

    def chan(fact, date_col, item_col, price_col):
        f = t[fact]
        return (f.join(m, on=f[date_col] == m["d_date_sk"])
                .join(sel_i, on=f[item_col] == sel_i["i_item_sk"])
                .groupBy("i_item_id")
                .agg(F.sum(F.col(price_col)).alias("total_sales")))

    u = (chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                     "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                     "ws_ext_sales_price")))
    return (u.groupBy("i_item_id")
            .agg(F.sum(F.col("total_sales")).alias("total_sales"))
            .sort(F.col("total_sales").desc(), "i_item_id")
            .limit(100))


def q58(s, t):
    """Items with balanced revenue across the three channels (TPC-DS 58:
    each channel within 90-110% of the three-channel average)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    period = dt.filter((F.col("d_year") == 2000) & (F.col("d_moy") == 6))

    def chan(fact, date_col, item_col, price_col, name):
        f = t[fact]
        return (f.join(period, on=f[date_col] == period["d_date_sk"])
                .join(item, on=f[item_col] == item["i_item_sk"])
                .groupBy("i_item_id")
                .agg(F.sum(F.col(price_col)).alias(name))
                .select(F.col("i_item_id").alias(f"{name}_id"),
                        F.col(name)))

    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_ext_sales_price", "ss_rev")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              "cs_ext_sales_price", "cs_rev")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
              "ws_ext_sales_price", "ws_rev")
    j = (ss.join(cs, on=ss["ss_rev_id"] == cs["cs_rev_id"])
         .join(ws, on=ss["ss_rev_id"] == ws["ws_rev_id"]))
    # ±50% band (the standard's ±10% selects ~nothing from the high-variance
    # toy-scale channel sums; the three-way balance shape is what matters)
    avg3 = (F.col("ss_rev") + F.col("cs_rev") + F.col("ws_rev")) / 3
    ok = ((F.col("ss_rev").between(0.5 * avg3, 1.5 * avg3))
          & (F.col("cs_rev").between(0.5 * avg3, 1.5 * avg3))
          & (F.col("ws_rev").between(0.5 * avg3, 1.5 * avg3)))
    return (j.filter(ok)
            .select(F.col("ss_rev_id").alias("item_id"), "ss_rev",
                    "cs_rev", "ws_rev")
            .sort("item_id")
            .limit(100))


def q59(s, t):
    """Store weekly sales year-over-year by day of week (TPC-DS 59)."""
    F = _F()
    ss, dt, store = t["store_sales"], t["date_dim"], t["store"]
    days = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday"]
    j = ss.join(dt, on=ss["ss_sold_date_sk"] == dt["d_date_sk"])
    aggs = [F.sum(F.when(F.col("d_day_name") == day,
                         F.col("ss_sales_price"))
                  .otherwise(F.lit(None)))
            .alias(f"{day[:3].lower()}_sales") for day in days]
    wss = j.groupBy("d_week_seq", "ss_store_sk").agg(*aggs)
    wk1 = dt.filter(F.col("d_month_seq").between(336, 347)) \
        .select("d_week_seq").distinct()
    wk2 = dt.filter(F.col("d_month_seq").between(348, 359)) \
        .select("d_week_seq").distinct()
    y = (wss.join(wk1, on=wss["d_week_seq"] == wk1["d_week_seq"],
                  how="leftsemi")
         .join(store, on=wss["ss_store_sk"] == store["s_store_sk"])
         .select(F.col("s_store_id").alias("s_id1"),
                 F.col("d_week_seq").alias("wk1"),
                 F.col("s_store_name"),
                 *[F.col(f"{d[:3].lower()}_sales") for d in days]))
    z = (wss.join(wk2, on=wss["d_week_seq"] == wk2["d_week_seq"],
                  how="leftsemi")
         .join(store, on=wss["ss_store_sk"] == store["s_store_sk"])
         .select(F.col("s_store_id").alias("s_id2"),
                 (F.col("d_week_seq") - 52).alias("wk2"),
                 *[F.col(f"{d[:3].lower()}_sales")
                   .alias(f"{d[:3].lower()}_sales2") for d in days]))
    jj = y.join(z, on=(y["s_id1"] == z["s_id2"]) & (y["wk1"] == z["wk2"]))
    ratios = [(F.col(f"{d[:3].lower()}_sales")
               / F.col(f"{d[:3].lower()}_sales2"))
              .alias(f"r_{d[:3].lower()}") for d in days]
    return (jj.select("s_store_name", F.col("s_id1"), F.col("wk1"),
                      *ratios)
            .sort("s_store_name", "s_id1", "wk1")
            .limit(100))


def q60(s, t):
    """Music-category revenue across all three channels (TPC-DS 60)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    m = dt.filter((F.col("d_year") == 1999) & (F.col("d_moy") == 9))
    sel_i = item.filter(F.col("i_category") == "Music")

    def chan(fact, date_col, item_col, price_col):
        f = t[fact]
        return (f.join(m, on=f[date_col] == m["d_date_sk"])
                .join(sel_i, on=f[item_col] == sel_i["i_item_sk"])
                .groupBy("i_item_id")
                .agg(F.sum(F.col(price_col)).alias("total_sales")))

    u = (chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                     "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                     "ws_ext_sales_price")))
    return (u.groupBy("i_item_id")
            .agg(F.sum(F.col("total_sales")).alias("total_sales"))
            .sort("i_item_id", F.col("total_sales").desc())
            .limit(100))


def q64_simplified(s, t):
    """Returned-item sale stats joined across two years (TPC-DS 64
    shape: the cross_sales self-join on item)."""
    F = _F()
    ss, sr, dt, item = (t["store_sales"], t["store_returns"],
                        t["date_dim"], t["item"])
    sel_i = item.filter(F.col("i_color").isin("almond", "azure", "blue",
                                              "brown", "beige", "cyan"))

    def cross_sales(year, name):
        y = dt.filter(F.col("d_year") == year)
        j = (ss.join(sr, on=(ss["ss_ticket_number"]
                             == sr["sr_ticket_number"])
                     & (ss["ss_item_sk"] == sr["sr_item_sk"]))
             .join(y, on=ss["ss_sold_date_sk"] == y["d_date_sk"])
             .join(sel_i, on=ss["ss_item_sk"] == sel_i["i_item_sk"]))
        return (j.groupBy("i_item_id")
                .agg(F.count_star().alias(f"{name}_cnt"),
                     F.sum(F.col("ss_wholesale_cost")).alias(f"{name}_wc"),
                     F.sum(F.col("ss_list_price")).alias(f"{name}_lp"))
                .select(F.col("i_item_id").alias(f"{name}_id"),
                        F.col(f"{name}_cnt"), F.col(f"{name}_wc"),
                        F.col(f"{name}_lp")))

    cs1 = cross_sales(2000, "y1")
    cs2 = cross_sales(2001, "y2")
    return (cs1.join(cs2, on=cs1["y1_id"] == cs2["y2_id"])
            .filter(F.col("y2_cnt") <= F.col("y1_cnt"))
            .select(F.col("y1_id").alias("item_id"), "y1_cnt", "y1_wc",
                    "y1_lp", "y2_cnt", "y2_wc", "y2_lp")
            .sort("item_id")
            .limit(100))


def q66(s, t):
    """Warehouse monthly revenue by channel (TPC-DS 66: 12 pivoted month
    columns over a web+catalog union)."""
    F = _F()
    dt, wh, sm = t["date_dim"], t["warehouse"], t["ship_mode"]
    y = dt.filter(F.col("d_year") == 2000)
    sel_sm = sm.filter(F.col("sm_carrier").isin("UPS", "FEDEX"))
    ws, cs = t["web_sales"], t["catalog_sales"]
    web = (ws.join(y, on=ws["ws_sold_date_sk"] == y["d_date_sk"])
           .join(sel_sm, on=ws["ws_ship_mode_sk"]
                 == sel_sm["sm_ship_mode_sk"])
           .join(wh, on=ws["ws_warehouse_sk"] == wh["w_warehouse_sk"])
           .select(F.col("w_warehouse_name"), F.col("d_moy"),
                   (F.col("ws_ext_sales_price") * F.col("ws_quantity"))
                   .alias("amt")))
    cat = (cs.join(y, on=cs["cs_sold_date_sk"] == y["d_date_sk"])
           .join(sel_sm, on=cs["cs_ship_mode_sk"]
                 == sel_sm["sm_ship_mode_sk"])
           .join(wh, on=cs["cs_warehouse_sk"] == wh["w_warehouse_sk"])
           .select(F.col("w_warehouse_name"), F.col("d_moy"),
                   (F.col("cs_ext_sales_price") * F.col("cs_quantity"))
                   .alias("amt")))
    u = web.union(cat)
    months = ["jan", "feb", "mar", "apr", "may", "jun", "jul", "aug",
              "sep", "oct", "nov", "dec"]
    aggs = [F.sum(F.when(F.col("d_moy") == i + 1, F.col("amt"))
                  .otherwise(0.0)).alias(f"{m}_sales")
            for i, m in enumerate(months)]
    return (u.groupBy("w_warehouse_name").agg(*aggs)
            .sort("w_warehouse_name")
            .limit(100))


def q69(s, t):
    """Demographics of store-only customers (TPC-DS 69: EXISTS +
    NOT EXISTS lowered to semi/anti joins)."""
    F = _F()
    cust, ca, cd, dt = (t["customer"], t["customer_address"],
                        t["customer_demographics"], t["date_dim"])
    period = dt.filter((F.col("d_year") == 2000)
                       & F.col("d_moy").between(1, 3))
    ss_cust = (t["store_sales"]
               .join(period, on=t["store_sales"]["ss_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ss_customer_sk").alias("a_cust")).distinct())
    ws_cust = (t["web_sales"]
               .join(period, on=t["web_sales"]["ws_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("ws_bill_customer_sk").alias("a_cust")))
    cs_cust = (t["catalog_sales"]
               .join(period, on=t["catalog_sales"]["cs_sold_date_sk"]
                     == period["d_date_sk"])
               .select(F.col("cs_bill_customer_sk").alias("a_cust")))
    sel_ca = ca.filter(F.col("ca_state").isin("TN", "CA", "TX"))
    j = (cust.join(ss_cust, on=cust["c_customer_sk"] == ss_cust["a_cust"],
                   how="leftsemi")
         .join(ws_cust, on=cust["c_customer_sk"] == ws_cust["a_cust"],
               how="leftanti")
         .join(cs_cust, on=cust["c_customer_sk"] == cs_cust["a_cust"],
               how="leftanti")
         .join(sel_ca, on=cust["c_current_addr_sk"]
               == sel_ca["ca_address_sk"])
         .join(cd, on=cust["c_current_cdemo_sk"] == cd["cd_demo_sk"]))
    return (j.groupBy("cd_gender", "cd_marital_status",
                      "cd_education_status")
            .agg(F.count_star().alias("cnt"),
                 F.min(F.col("cd_purchase_estimate")).alias("min_est"),
                 F.max(F.col("cd_purchase_estimate")).alias("max_est"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status")
            .limit(100))


def q70(s, t):
    """State/county profit ROLLUP restricted to top-5 states with ranking
    inside each hierarchy level (TPC-DS 70)."""
    F = _F()
    from .window import Window
    ss, dt, store = t["store_sales"], t["date_dim"], t["store"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))
    by_state = (ss.join(period, on=ss["ss_sold_date_sk"]
                        == period["d_date_sk"])
                .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
                .groupBy("s_state")
                .agg(F.sum(F.col("ss_net_profit")).alias("state_profit")))
    top5 = (by_state.withColumn(
        "rnk", F.rank().over(Window.orderBy(
            F.col("state_profit").desc())))
        .filter(F.col("rnk") <= 5)
        .select(F.col("s_state").alias("top_state")))
    g = (ss.join(period, on=ss["ss_sold_date_sk"] == period["d_date_sk"])
         .join(store, on=ss["ss_store_sk"] == store["s_store_sk"])
         .join(top5, on=store["s_state"] == top5["top_state"],
               how="leftsemi")
         .rollup("s_state", "s_county")
         .agg(F.sum(F.col("ss_net_profit")).alias("total_sum"),
              F.grouping("s_state").alias("g_state"),
              F.grouping("s_county").alias("g_county")))
    g = g.withColumn("lochierarchy", F.col("g_state") + F.col("g_county"))
    w = Window.partitionBy("lochierarchy").orderBy(
        F.col("total_sum").desc())
    return (g.withColumn("rank_within_parent", F.rank().over(w))
            .select("total_sum", "s_state", "s_county", "lochierarchy",
                    "rank_within_parent")
            .sort(F.col("lochierarchy").desc(), "s_state",
                  "rank_within_parent")
            .limit(100))


def q71(s, t):
    """Brand revenue in breakfast and dinner hours across channels
    (TPC-DS 71)."""
    F = _F()
    dt, item, td = t["date_dim"], t["item"], t["time_dim"]
    m = dt.filter((F.col("d_moy") == 11) & (F.col("d_year") == 2000))
    sel_i = item.filter(F.col("i_manager_id") <= 10)
    meal = td.filter(F.col("t_hour").isin(8, 9, 19, 20))
    ws, ss = t["web_sales"], t["store_sales"]
    web = (ws.join(m, on=ws["ws_sold_date_sk"] == m["d_date_sk"])
           .select(F.col("ws_ext_sales_price").alias("price"),
                   F.col("ws_item_sk").cast("long").alias("item_sk"),
                   F.col("ws_sold_time_sk").alias("time_sk")))
    st = (ss.join(m, on=ss["ss_sold_date_sk"] == m["d_date_sk"])
          .select(F.col("ss_ext_sales_price").alias("price"),
                  F.col("ss_item_sk").cast("long").alias("item_sk"),
                  F.col("ss_sold_time_sk").alias("time_sk")))
    u = web.union(st)
    j = (u.join(sel_i, on=u["item_sk"] == sel_i["i_item_sk"])
         .join(meal, on=u["time_sk"] == meal["t_time_sk"]))
    return (j.groupBy("i_brand_id", "i_brand", "t_hour")
            .agg(F.sum(F.col("price")).alias("ext_price"))
            .sort(F.col("ext_price").desc(), "i_brand_id", "t_hour")
            .limit(100))


def q72(s, t):
    """Catalog demand exceeding inventory on hand (TPC-DS 72: non-equi
    residual join against inventory)."""
    F = _F()
    cs, inv, dt, item, wh, hd = (t["catalog_sales"], t["inventory"],
                                 t["date_dim"], t["item"], t["warehouse"],
                                 t["household_demographics"])
    y = dt.filter(F.col("d_year") == 2000)
    sel_hd = hd.filter(F.col("hd_buy_potential") == ">10000")
    j = (cs.join(y, on=cs["cs_sold_date_sk"] == y["d_date_sk"])
         .join(sel_hd, on=cs["cs_bill_hdemo_sk"] == sel_hd["hd_demo_sk"])
         .join(inv, on=(cs["cs_item_sk"] == inv["inv_item_sk"])
               & (inv["inv_quantity_on_hand"] < cs["cs_quantity"]))
         .join(item, on=cs["cs_item_sk"] == item["i_item_sk"])
         .join(wh, on=inv["inv_warehouse_sk"] == wh["w_warehouse_sk"]))
    return (j.groupBy("i_item_id", "w_warehouse_name", "d_week_seq")
            .agg(F.count_star().alias("no_promo"))
            .sort(F.col("no_promo").desc(), "i_item_id",
                  "w_warehouse_name", "d_week_seq")
            .limit(100))


def q74(s, t):
    """Customers whose web net-paid growth beats store growth
    (TPC-DS 74: q11's skeleton on ss_net_paid)."""
    F = _F()
    cust = t["customer"]

    def yt(fact, date_col, cust_col, amt_col, year, name):
        return _year_total(t, fact, date_col, cust_col, F.col(amt_col),
                           year) \
            .select(F.col(cust_col).alias(f"{name}_cust"),
                    F.col("year_total").alias(name))

    ss1 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk",
             "ss_net_paid", 1999, "ss1")
    ss2 = yt("store_sales", "ss_sold_date_sk", "ss_customer_sk",
             "ss_net_paid", 2000, "ss2")
    ws1 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
             "ws_net_paid", 1999, "ws1")
    ws2 = yt("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk",
             "ws_net_paid", 2000, "ws2")
    j = (ss1.join(ss2, on=ss1["ss1_cust"] == ss2["ss2_cust"])
         .join(ws1, on=ss1["ss1_cust"] == ws1["ws1_cust"])
         .join(ws2, on=ss1["ss1_cust"] == ws2["ws2_cust"])
         .filter(F.col("ws2") / F.col("ws1")
                 > F.col("ss2") / F.col("ss1")))
    return (j.join(cust, on=j["ss1_cust"] == cust["c_customer_sk"])
            .select("c_customer_id", "c_first_name", "c_last_name")
            .sort("c_customer_id")
            .limit(100))


def q75_brand_years(s, t):
    """q75 without its filter, ORDER BY and LIMIT: each brand's 2000 and
    1999 sales count and amount, joined."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    sel_i = item.filter(F.col("i_category") == "Books")

    def chan(fact, ret, date_col, item_col, order_col, qty_col, price_col,
             r_item, r_order, r_qty, r_amt):
        f, r = t[fact], t[ret]
        rsel = r.select(F.col(r_item).alias("r_item"),
                        F.col(r_order).alias("r_order"),
                        F.col(r_qty).alias("r_qty"),
                        F.col(r_amt).alias("r_amt"))
        j = (f.join(dt, on=f[date_col] == dt["d_date_sk"])
             .join(sel_i, on=f[item_col] == sel_i["i_item_sk"])
             .join(rsel, on=(f[item_col] == rsel["r_item"])
                   & (f[order_col] == rsel["r_order"]), how="left"))
        return j.select(
            F.col("d_year"), F.col("i_brand"),
            (F.col(qty_col) - F.coalesce(F.col("r_qty"), F.lit(0)))
            .alias("sales_cnt"),
            (F.col(price_col) - F.coalesce(F.col("r_amt"), F.lit(0.0)))
            .alias("sales_amt"))

    u = (chan("store_sales", "store_returns", "ss_sold_date_sk",
              "ss_item_sk", "ss_ticket_number", "ss_quantity",
              "ss_ext_sales_price", "sr_item_sk", "sr_ticket_number",
              "sr_return_quantity", "sr_return_amt")
         .union(chan("catalog_sales", "catalog_returns", "cs_sold_date_sk",
                     "cs_item_sk", "cs_order_number", "cs_quantity",
                     "cs_ext_sales_price", "cr_item_sk", "cr_order_number",
                     "cr_return_quantity", "cr_return_amount"))
         .union(chan("web_sales", "web_returns", "ws_sold_date_sk",
                     "ws_item_sk", "ws_order_number", "ws_quantity",
                     "ws_ext_sales_price", "wr_item_sk", "wr_order_number",
                     "wr_return_quantity", "wr_return_amt")))
    g = (u.groupBy("d_year", "i_brand")
         .agg(F.sum(F.col("sales_cnt")).alias("sales_cnt"),
              F.sum(F.col("sales_amt")).alias("sales_amt")))
    curr = g.filter(F.col("d_year") == 2000).select(
        F.col("i_brand").alias("c_brand"),
        F.col("sales_cnt").alias("c_cnt"),
        F.col("sales_amt").alias("c_amt"))
    prev = g.filter(F.col("d_year") == 1999).select(
        F.col("i_brand").alias("p_brand"),
        F.col("sales_cnt").alias("p_cnt"),
        F.col("sales_amt").alias("p_amt"))
    return curr.join(prev, on=curr["c_brand"] == prev["p_brand"])


def q75(s, t):
    """Brands losing volume year over year (TPC-DS 75: sales net of
    returns unioned across channels, self-joined on prior year)."""
    F = _F()
    return (q75_brand_years(s, t)
            .filter((F.col("p_cnt") > 0)
                    & (F.col("c_cnt").cast("double") / F.col("p_cnt")
                       < 0.9))
            .select(F.col("c_brand").alias("i_brand"), "p_cnt", "c_cnt",
                    (F.col("c_cnt") - F.col("p_cnt")).alias("cnt_diff"),
                    (F.col("c_amt") - F.col("p_amt")).alias("amt_diff"))
            .sort("cnt_diff", "i_brand")
            .limit(100))


def q76(s, t):
    """Sales rows with a NULL measure per channel (TPC-DS 76)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]

    def chan(fact, date_col, item_col, null_col, price_col, name):
        f = t[fact]
        return (f.filter(F.isnull(F.col(null_col)))
                .join(dt, on=f[date_col] == dt["d_date_sk"])
                .join(item, on=f[item_col] == item["i_item_sk"])
                .select(F.lit(name).alias("channel"),
                        F.lit(null_col).alias("col_name"),
                        F.col("d_year"), F.col("d_qoy"),
                        F.col("i_category"),
                        F.col(price_col).alias("ext_sales_price")))

    u = (chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_quantity", "ss_ext_sales_price", "store")
         .union(chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                     "ws_quantity", "ws_ext_sales_price", "web"))
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                     "cs_quantity", "cs_ext_sales_price", "catalog")))
    return (u.groupBy("channel", "col_name", "d_year", "d_qoy",
                      "i_category")
            .agg(F.count_star().alias("sales_cnt"),
                 F.sum(F.col("ext_sales_price")).alias("sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy", "i_category")
            .limit(100))


def q78(s, t):
    """Non-returned sales per customer/item/year across channels
    (TPC-DS 78: LEFT JOIN returns, keep the never-returned rows)."""
    F = _F()
    dt = t["date_dim"]

    def chan(fact, ret, date_col, item_col, order_col, cust_col, qty_col,
             price_col, r_item, r_order, name):
        f, r = t[fact], t[ret]
        rsel = r.select(F.col(r_item).alias("r_item"),
                        F.col(r_order).alias("r_order"))
        j = (f.join(rsel, on=(f[item_col] == rsel["r_item"])
                    & (f[order_col] == rsel["r_order"]), how="leftanti")
             .join(dt, on=f[date_col] == dt["d_date_sk"]))
        return (j.groupBy("d_year", item_col, cust_col)
                .agg(F.sum(F.col(qty_col)).alias(f"{name}_qty"),
                     F.sum(F.col(price_col)).alias(f"{name}_amt"))
                .select(F.col("d_year").alias(f"{name}_year"),
                        F.col(item_col).alias(f"{name}_item"),
                        F.col(cust_col).alias(f"{name}_cust"),
                        F.col(f"{name}_qty"), F.col(f"{name}_amt")))

    ss = chan("store_sales", "store_returns", "ss_sold_date_sk",
              "ss_item_sk", "ss_ticket_number", "ss_customer_sk",
              "ss_quantity", "ss_ext_sales_price", "sr_item_sk",
              "sr_ticket_number", "ss")
    ws = chan("web_sales", "web_returns", "ws_sold_date_sk", "ws_item_sk",
              "ws_order_number", "ws_bill_customer_sk", "ws_quantity",
              "ws_ext_sales_price", "wr_item_sk", "wr_order_number", "ws")
    j = ss.join(ws, on=(ss["ss_year"] == ws["ws_year"])
                & (ss["ss_item"] == ws["ws_item"])
                & (ss["ss_cust"] == ws["ws_cust"]))
    return (j.filter(F.col("ws_qty") > 0)
            .select(F.col("ss_year").alias("year"),
                    F.col("ss_item").alias("item"),
                    F.col("ss_cust").alias("customer"),
                    F.round(F.col("ss_qty").cast("double")
                            / F.col("ws_qty"), 2).alias("ratio"),
                    "ss_qty", "ss_amt", "ws_qty", "ws_amt")
            .sort("year", "item", "customer")
            .limit(100))


def q83(s, t):
    """Return quantities per item across the three return channels
    (TPC-DS 83)."""
    F = _F()
    dt, item = t["date_dim"], t["item"]
    period = dt.filter(F.col("d_month_seq").between(350, 353))

    def chan(ret, date_col, item_col, qty_col, name):
        r = t[ret]
        return (r.join(period, on=r[date_col] == period["d_date_sk"])
                .join(item, on=r[item_col] == item["i_item_sk"])
                .groupBy("i_item_id")
                .agg(F.sum(F.col(qty_col)).alias(name))
                .select(F.col("i_item_id").alias(f"{name}_id"),
                        F.col(name)))

    sr = chan("store_returns", "sr_returned_date_sk", "sr_item_sk",
              "sr_return_quantity", "sr_qty")
    cr = chan("catalog_returns", "cr_returned_date_sk", "cr_item_sk",
              "cr_return_quantity", "cr_qty")
    wr = chan("web_returns", "wr_returned_date_sk", "wr_item_sk",
              "wr_return_quantity", "wr_qty")
    j = (sr.join(cr, on=sr["sr_qty_id"] == cr["cr_qty_id"])
         .join(wr, on=sr["sr_qty_id"] == wr["wr_qty_id"]))
    total = (F.col("sr_qty") + F.col("cr_qty") + F.col("wr_qty"))
    return (j.select(F.col("sr_qty_id").alias("item_id"), "sr_qty",
                     "cr_qty", "wr_qty",
                     F.round(F.col("sr_qty") / total * 100.0, 2)
                     .alias("sr_dev"),
                     F.round(F.col("cr_qty") / total * 100.0, 2)
                     .alias("cr_dev"),
                     F.round(F.col("wr_qty") / total * 100.0, 2)
                     .alias("wr_dev"))
            .sort("item_id")
            .limit(100))


def q84(s, t):
    """Returning customers in an income band and city (TPC-DS 84)."""
    F = _F()
    cust, ca, hd, ib, sr = (t["customer"], t["customer_address"],
                            t["household_demographics"], t["income_band"],
                            t["store_returns"])
    sel_ca = ca.filter(F.col("ca_city").isin("city0", "city1", "city2",
                                             "city3", "city4"))
    sel_ib = ib.filter((F.col("ib_lower_bound") >= 0)
                       & (F.col("ib_upper_bound") <= 100000 - 1))
    returned = sr.select(F.col("sr_customer_sk").alias("r_cust")).distinct()
    j = (cust.join(sel_ca, on=cust["c_current_addr_sk"]
                   == sel_ca["ca_address_sk"])
         .join(hd, on=cust["c_current_hdemo_sk"] == hd["hd_demo_sk"])
         .join(sel_ib, on=hd["hd_income_band_sk"]
               == sel_ib["ib_income_band_sk"])
         .join(returned, on=cust["c_customer_sk"] == returned["r_cust"],
               how="leftsemi"))
    return (j.select(F.col("c_customer_id").alias("customer_id"),
                     F.concat(F.col("c_last_name"), F.lit(", "),
                              F.col("c_first_name"))
                     .alias("customername"),
                     "ca_city")
            .sort("customer_id")
            .limit(100))


def q85(s, t):
    """Web return reasons with demographic brackets (TPC-DS 85)."""
    F = _F()
    wr, reason, cust, cd, dt = (t["web_returns"], t["reason"],
                                t["customer"],
                                t["customer_demographics"], t["date_dim"])
    y = dt.filter(F.col("d_year") == 2000)
    b1 = ((F.col("cd_marital_status") == "M")
          & (F.col("cd_education_status") == "4 yr Degree"))
    b2 = ((F.col("cd_marital_status") == "S")
          & (F.col("cd_education_status") == "College"))
    b3 = ((F.col("cd_marital_status") == "W")
          & (F.col("cd_education_status") == "2 yr Degree"))
    j = (wr.join(y, on=wr["wr_returned_date_sk"] == y["d_date_sk"])
         .join(reason, on=wr["wr_reason_sk"] == reason["r_reason_sk"])
         .join(cust, on=wr["wr_returning_customer_sk"]
               == cust["c_customer_sk"])
         .join(cd, on=cust["c_current_cdemo_sk"] == cd["cd_demo_sk"])
         .filter(b1 | b2 | b3))
    return (j.groupBy("r_reason_desc")
            .agg(F.avg(F.col("wr_return_quantity")).alias("avg_qty"),
                 F.avg(F.col("wr_return_amt")).alias("avg_amt"),
                 F.avg(F.col("wr_net_loss")).alias("avg_loss"))
            .sort("r_reason_desc")
            .limit(100))


def q86(s, t):
    """Web net-paid rollup with rank inside hierarchy level (TPC-DS 86:
    q36's shape on the web channel)."""
    F = _F()
    from .window import Window
    ws, dt, item = t["web_sales"], t["date_dim"], t["item"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))
    g = (ws.join(period, on=ws["ws_sold_date_sk"] == period["d_date_sk"])
         .join(item, on=ws["ws_item_sk"] == item["i_item_sk"])
         .rollup("i_category", "i_class")
         .agg(F.sum(F.col("ws_net_paid")).alias("total_sum"),
              F.grouping("i_category").alias("g_cat"),
              F.grouping("i_class").alias("g_class")))
    g = g.withColumn("lochierarchy", F.col("g_cat") + F.col("g_class"))
    w = Window.partitionBy("lochierarchy").orderBy(
        F.col("total_sum").desc())
    return (g.withColumn("rank_within_parent", F.rank().over(w))
            .select("total_sum", "i_category", "i_class", "lochierarchy",
                    "rank_within_parent")
            .sort(F.col("lochierarchy").desc(), "i_category",
                  "rank_within_parent")
            .limit(100))


def q91(s, t):
    """Call-center catalog return losses by demographic (TPC-DS 91)."""
    F = _F()
    cr, cc, dt, cust, cd, hd = (t["catalog_returns"], t["call_center"],
                                t["date_dim"], t["customer"],
                                t["customer_demographics"],
                                t["household_demographics"])
    m = dt.filter(F.col("d_year") == 1998)
    sel_cd = cd.filter(F.col("cd_marital_status").isin("M", "W"))
    sel_hd = hd.filter(F.col("hd_buy_potential").isin(
        ">10000", "5001-10000", "Unknown"))
    j = (cr.join(m, on=cr["cr_returned_date_sk"] == m["d_date_sk"])
         .join(cc, on=cr["cr_call_center_sk"] == cc["cc_call_center_sk"])
         .join(cust, on=cr["cr_returning_customer_sk"]
               == cust["c_customer_sk"])
         .join(sel_cd, on=cust["c_current_cdemo_sk"]
               == sel_cd["cd_demo_sk"])
         .join(sel_hd, on=cust["c_current_hdemo_sk"]
               == sel_hd["hd_demo_sk"]))
    return (j.groupBy("cc_name", "cc_manager", "cd_marital_status",
                      "cd_education_status")
            .agg(F.sum(F.col("cr_net_loss")).alias("returns_loss"))
            .sort(F.col("returns_loss").desc(), "cc_name", "cc_manager")
            .limit(100))


def q93(s, t):
    """Actual sales after reason-coded returns (TPC-DS 93)."""
    F = _F()
    ss, sr, reason = t["store_sales"], t["store_returns"], t["reason"]
    sel_r = reason.filter(F.col("r_reason_desc").isin(
        "reason 01", "reason 02", "reason 03"))
    rsel = (sr.join(sel_r, on=sr["sr_reason_sk"] == sel_r["r_reason_sk"],
                    how="leftsemi")
            .select(F.col("sr_ticket_number").alias("r_ticket"),
                    F.col("sr_item_sk").alias("r_item"),
                    F.col("sr_return_quantity").alias("r_qty")))
    j = ss.join(rsel, on=(ss["ss_ticket_number"] == rsel["r_ticket"])
                & (ss["ss_item_sk"] == rsel["r_item"]), how="left")
    act = F.when(F.isnull(F.col("r_qty")),
                 F.col("ss_quantity") * F.col("ss_sales_price")) \
        .otherwise((F.col("ss_quantity") - F.col("r_qty"))
                   * F.col("ss_sales_price"))
    return (j.withColumn("act_sales", act)
            .groupBy("ss_customer_sk")
            .agg(F.sum(F.col("act_sales")).alias("sumsales"))
            .sort("sumsales", "ss_customer_sk")
            .limit(100))


def q94(s, t):
    """Multi-warehouse web orders never returned (TPC-DS 94)."""
    F = _F()
    ws, wr, dt, site = (t["web_sales"], t["web_returns"], t["date_dim"],
                        t["web_site"])
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10645)))
    multi_wh = (t["web_sales"]
                .select("ws_order_number", "ws_warehouse_sk").distinct()
                .groupBy("ws_order_number")
                .agg(F.count_star().alias("n_wh"))
                .filter(F.col("n_wh") > 1)
                .select(F.col("ws_order_number").alias("mw_order")))
    base = (ws.join(days, on=ws["ws_ship_date_sk"] == days["d_date_sk"])
            .join(site, on=ws["ws_web_site_sk"] == site["web_site_sk"])
            .join(multi_wh, on=ws["ws_order_number"] == multi_wh["mw_order"],
                  how="leftsemi")
            .join(wr.select(F.col("wr_order_number").alias("r_order")),
                  on=ws["ws_order_number"] == F.col("r_order"),
                  how="leftanti"))
    orders = (base.select("ws_order_number").distinct()
              .agg(F.count_star().alias("order_count")))
    money = base.agg(F.sum(F.col("ws_ext_tax")).alias("total_tax"),
                     F.sum(F.col("ws_net_profit")).alias("total_profit"))
    return orders.crossJoin(money)


def q95(s, t):
    """Multi-warehouse web orders WITH returns (TPC-DS 95: q94's shape
    with EXISTS instead of NOT EXISTS)."""
    F = _F()
    ws, wr, dt, site = (t["web_sales"], t["web_returns"], t["date_dim"],
                        t["web_site"])
    days = dt.filter((F.col("d_date") >= F.lit(10585))
                     & (F.col("d_date") <= F.lit(10645)))
    multi_wh = (t["web_sales"]
                .select("ws_order_number", "ws_warehouse_sk").distinct()
                .groupBy("ws_order_number")
                .agg(F.count_star().alias("n_wh"))
                .filter(F.col("n_wh") > 1)
                .select(F.col("ws_order_number").alias("mw_order")))
    base = (ws.join(days, on=ws["ws_ship_date_sk"] == days["d_date_sk"])
            .join(site, on=ws["ws_web_site_sk"] == site["web_site_sk"])
            .join(multi_wh, on=ws["ws_order_number"] == multi_wh["mw_order"],
                  how="leftsemi")
            .join(wr.select(F.col("wr_order_number").alias("r_order")),
                  on=ws["ws_order_number"] == F.col("r_order"),
                  how="leftsemi"))
    orders = (base.select("ws_order_number").distinct()
              .agg(F.count_star().alias("order_count")))
    money = base.agg(F.sum(F.col("ws_ext_tax")).alias("total_tax"),
                     F.sum(F.col("ws_net_profit")).alias("total_profit"))
    return orders.crossJoin(money)


def q97(s, t):
    """Store/catalog customer-item overlap (TPC-DS 97: FULL OUTER join of
    the two distinct purchase sets)."""
    F = _F()
    dt = t["date_dim"]
    period = dt.filter(F.col("d_month_seq").between(350, 361))
    ss, cs = t["store_sales"], t["catalog_sales"]
    ssci = (ss.join(period, on=ss["ss_sold_date_sk"] == period["d_date_sk"])
            .select(F.col("ss_customer_sk").alias("s_cust"),
                    F.col("ss_item_sk").alias("s_item")).distinct())
    csci = (cs.join(period, on=cs["cs_sold_date_sk"] == period["d_date_sk"])
            .select(F.col("cs_bill_customer_sk").alias("c_cust"),
                    F.col("cs_item_sk").alias("c_item")).distinct())
    j = ssci.join(csci, on=(ssci["s_cust"] == csci["c_cust"])
                  & (ssci["s_item"] == csci["c_item"]), how="full")
    return j.agg(
        F.sum(F.when(F.isnull(F.col("c_cust"))
                     & ~F.isnull(F.col("s_cust")), 1).otherwise(0))
        .alias("store_only"),
        F.sum(F.when(~F.isnull(F.col("s_cust"))
                     & ~F.isnull(F.col("c_cust")), 1).otherwise(0))
        .alias("store_and_catalog"),
        F.sum(F.when(F.isnull(F.col("s_cust"))
                     & ~F.isnull(F.col("c_cust")), 1).otherwise(0))
        .alias("catalog_only"))


QUERIES = {
    "q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5_rollup, "q6": q6,
    "q7": q7, "q8": q8, "q9": q9, "q10": q10, "q11": q11, "q12": q12,
    "q13": q13, "q14": q14_simplified, "q15": q15, "q16": q16, "q17": q17,
    "q18": q18, "q19": q19, "q20": q20, "q21": q21, "q22": q22,
    "q23": q23_simplified, "q24": q24_simplified, "q25": q25, "q26": q26,
    "q27": q27, "q28": q28, "q29": q29, "q30": q30, "q31": q31, "q32": q32,
    "q33": q33_simplified, "q34": q34, "q35": q35, "q36": q36, "q37": q37,
    "q38": q38, "q39": q39, "q40": q40, "q41": q41, "q42": q42, "q43": q43,
    "q44": q44, "q45": q45, "q46": q46, "q47": q47, "q48": q48, "q49": q49,
    "q50": q50, "q51": q51, "q52": q52, "q53": q53, "q54": q54, "q55": q55,
    "q56": q56, "q57": q57, "q58": q58, "q59": q59, "q60": q60,
    "q64": q64_simplified, "q61": q61, "q62": q62, "q63": q63, "q65": q65,
    "q66": q66, "q67": q67, "q68": q68, "q69": q69, "q70": q70, "q71": q71,
    "q72": q72, "q73": q73, "q74": q74, "q75": q75, "q76": q76, "q77": q77,
    "q78": q78, "q79": q79, "q80": q80, "q81": q81, "q82": q82, "q83": q83,
    "q84": q84, "q85": q85, "q86": q86, "q87": q87, "q88": q88_simplified,
    "q89": q89, "q90": q90, "q91": q91, "q92": q92, "q93": q93, "q94": q94,
    "q95": q95, "q96": q96, "q97": q97, "q98": q98, "q99": q99,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--queries", default=",".join(QUERIES))
    ap.add_argument("--device", default=None,
                    help="torch device (the card unless 'cpu')")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        # the CPU has no device memory to read: state one for the budget
        from .memory.device import TorchDeviceManager
        TorchDeviceManager.initialize(device="cpu", total_bytes=8 << 30)
    s = make_session(args.device)
    tables = load_tables(s, args.rows)
    results = {}
    for name in args.queries.split(","):
        df = QUERIES[name.strip()](s, tables)
        t0 = time.perf_counter()
        out = df.collect()
        results[f"{name}_s"] = round(time.perf_counter() - t0, 4)
        results[f"{name}_rows"] = len(out)
    print(json.dumps({"metric": "tpcds_suite", "rows": args.rows,
                      **results}))


if __name__ == "__main__":
    main()
