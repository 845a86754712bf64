select s_store_name, sum(ss_net_profit)
from store_sales, date_dim, store,
     (select ca_zip
      from ((select substring(ca_zip, 1, 5) ca_zip
             from customer_address
             where substring(ca_zip, 1, 5) in
                   ('10043', '10079', '10109', '10125', '10129',
                    '10483', '11262', '13063', '13297', '14539',
                    '17227', '18621', '22529', '23255', '25586',
                    '28367', '30009', '33021', '36420', '39986'))
            intersect
            (select ca_zip
             from (select substring(ca_zip, 1, 5) ca_zip, count(*) cnt
                   from customer_address, customer
                   where ca_address_sk = c_current_addr_sk
                     and c_preferred_cust_flag = 'Y'
                   group by ca_zip
                   having count(*) > 1) a1)) a2) v1
where ss_store_sk = s_store_sk
  and ss_sold_date_sk = d_date_sk
  and d_qoy = {qoy} and d_year = {year}
  and (substring(s_zip, 1, 2) = substring(v1.ca_zip, 1, 2))
group by s_store_name
order by s_store_name
limit 100
